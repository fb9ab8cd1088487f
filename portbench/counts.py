"""Operations and bytes of the measured work, and the card's peaks.

Counted from the shapes the benchmark handed in, never from what the
program reports, so a change to the program does not move the
yardstick.  A multiply-add is two operations.  Bytes count each input
read once and each output written once, in the stored type.

``Dense`` describes a dense decoder by its widths; a causal attention
piece is ``c`` query rows at positions ``s .. s + c - 1`` over the keys
at positions ``0 .. s + c - 1``.
"""

from __future__ import annotations

import dataclasses

# NVIDIA H100 SXM data sheet, dense rates, at the card's full 700 W
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12}


@dataclasses.dataclass(frozen=True)
class Dense:
    layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int              # rows of the tied embedding the head reads
    bytes_per_el: int = 2

    @property
    def layer_params(self) -> int:
        """Weights of one block's projections (the norms' scales are
        elementwise and left out)."""
        d, hd = self.d_model, self.head_dim
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) \
            + self.n_heads * hd * d
        return attn + 3 * d * self.d_ff

    def attn_flops(self, s: int, c: int) -> float:
        """Causal attention of one piece in one layer: the scores and
        the weighted sum over the visible keys, c * s + c (c + 1) / 2
        pairs, for every query head."""
        pairs = c * s + c * (c + 1) / 2
        return 4.0 * self.n_heads * self.head_dim * pairs

    def attn_bytes(self, s: int, c: int) -> float:
        """One layer's attention of one piece: q read and o written (c
        rows of every query head), k and v read (s + c rows of every kv
        head)."""
        hd, b = self.head_dim, self.bytes_per_el
        return b * hd * (2 * c * self.n_heads + 2 * (s + c) * self.n_kv_heads)

    def prefill_flops(self, s: int, c: int, head_rows: int) -> float:
        """Every layer's projections for c tokens, their attention, and
        the head for ``head_rows`` rows (1 where the piece ends a prompt:
        only the first token's logits are needed)."""
        return self.layers * (2.0 * self.layer_params * c
                              + self.attn_flops(s, c)) \
            + 2.0 * self.d_model * self.vocab * head_rows

    def train_flops(self, batch: int, seq: int) -> float:
        """A training step: three times the forward of ``batch`` rows of
        ``seq`` tokens, the head on every token (the recompute of
        activation checkpointing is left out)."""
        return 3.0 * batch * self.prefill_flops(0, seq, seq)

    def train_attn(self, batch: int, seq: int) -> tuple[float, float]:
        """(operations, bytes) the attention of a training step needs:
        the forward counted once, and the backward's four products (the
        gradients of the scores and of q, k and v) with q, k, v, o and
        the output's gradient read and the three gradients written."""
        fwd_f = self.layers * batch * self.attn_flops(0, seq)
        fwd_b = self.layers * batch * self.attn_bytes(0, seq)
        hd, b = self.head_dim, self.bytes_per_el
        rows_q, rows_kv = seq * self.n_heads, seq * self.n_kv_heads
        bwd_b = self.layers * batch * b * hd * (3 * rows_q + 2 * rows_kv
                                                + rows_q + 2 * rows_kv)
        return 3.0 * fwd_f, fwd_b + bwd_b


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs: the larger of the operations at
    the bf16 peak and the bytes at the memory's peak."""
    return max(flops / PEAKS["bf16_flops"], nbytes / PEAKS["hbm_bytes_per_s"])
