"""Loop-nest IR for CNN-like computations (paper §3.1).

The convolutional layer is a 6-deep loop nest over (Fw, Fh, X, Y, C, K)
(7-deep with the batch dimension N).  A *blocking string* is an ordered
sequence of loops, innermost first, where each dimension may appear several
times (multi-level blocking).  Following the paper's notation, the value
attached to the i-th occurrence of a dimension is the *cumulative extent*
covered by that loop and everything below it: for ``X0=8, X1=64`` the inner
loop covers 8 output columns and the outer loop iterates ``64/8`` times.

A fully-connected layer (or any GEMM, e.g. a transformer projection) is the
degenerate conv ``Fw=Fh=1, Y=1`` with ``X=M`` (rows), ``C=K_reduce``,
``K=N_cols`` — see :func:`Problem.gemm`.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import math
from typing import Iterable, Sequence


class Dim(enum.Enum):
    FW = "Fw"
    FH = "Fh"
    X = "X"
    Y = "Y"
    C = "C"
    K = "K"
    N = "N"  # batch of images / tokens

    def __repr__(self) -> str:  # compact reprs in blocking strings
        return self.value


# Which dimensions index each operand.  Inputs are indexed by X/Y via the
# sliding window (plus the halo), weights by (Fw, Fh, C, K), outputs by
# (X, Y, K, N).  N indexes inputs and outputs but not weights.
INPUT_DIMS = frozenset({Dim.X, Dim.Y, Dim.C, Dim.N, Dim.FW, Dim.FH})
WEIGHT_DIMS = frozenset({Dim.FW, Dim.FH, Dim.C, Dim.K})
OUTPUT_DIMS = frozenset({Dim.X, Dim.Y, Dim.K, Dim.N})
REDUCTION_DIMS = frozenset({Dim.C, Dim.FW, Dim.FH})


@dataclasses.dataclass(frozen=True)
class Problem:
    """Dimensions of one convolutional (or FC) layer.

    ``bytes_per_elem`` is the uniform element width (the paper uses 16-bit
    data throughout); mixed-precision nests override it per operand with
    ``input_bytes`` / ``weight_bytes`` / ``output_bytes`` (``None`` means
    "same as bytes_per_elem").  Element width is a first-class blocking
    parameter: the access/energy model counts traffic in bytes, so a
    1-byte weight operand lets twice the weight tile fit in the same
    buffer and shifts the optimum — exactly the lever quantization pulls.
    """

    X: int
    Y: int
    C: int
    K: int
    Fw: int = 1
    Fh: int = 1
    N: int = 1
    stride: int = 1
    bytes_per_elem: int = 2  # the paper uses 16-bit data throughout
    input_bytes: int | None = None    # activations (w8a8: 1)
    weight_bytes: int | None = None   # weights / KV stream (w8: 1, fp8: 1)
    output_bytes: int | None = None

    @classmethod
    def gemm(cls, M: int, N_cols: int, K_reduce: int, batch: int = 1,
             bytes_per_elem: int = 2,
             input_bytes: int | None = None,
             weight_bytes: int | None = None,
             output_bytes: int | None = None) -> "Problem":
        """A GEMM (FC layer / transformer projection) as a degenerate conv."""
        return cls(X=M, Y=1, C=K_reduce, K=N_cols, Fw=1, Fh=1, N=batch,
                   bytes_per_elem=bytes_per_elem, input_bytes=input_bytes,
                   weight_bytes=weight_bytes, output_bytes=output_bytes)

    @property
    def input_bpe(self) -> int:
        return self.input_bytes or self.bytes_per_elem

    @property
    def weight_bpe(self) -> int:
        return self.weight_bytes or self.bytes_per_elem

    @property
    def output_bpe(self) -> int:
        return self.output_bytes or self.bytes_per_elem

    def full_extent(self, d: Dim) -> int:
        return {Dim.X: self.X, Dim.Y: self.Y, Dim.C: self.C, Dim.K: self.K,
                Dim.FW: self.Fw, Dim.FH: self.Fh, Dim.N: self.N}[d]

    @property
    def macs(self) -> int:
        return (self.N * self.X * self.Y * self.C * self.K * self.Fw *
                self.Fh)

    @property
    def input_x(self) -> int:
        return (self.X - 1) * self.stride + self.Fw

    @property
    def input_y(self) -> int:
        return (self.Y - 1) * self.stride + self.Fh

    @property
    def input_elems(self) -> int:
        return self.N * self.input_x * self.input_y * self.C

    @property
    def weight_elems(self) -> int:
        return self.Fw * self.Fh * self.C * self.K

    @property
    def output_elems(self) -> int:
        return self.N * self.X * self.Y * self.K

    def total_bytes(self) -> int:
        return (self.input_elems * self.input_bpe +
                self.weight_elems * self.weight_bpe +
                self.output_elems * self.output_bpe)


@dataclasses.dataclass(frozen=True)
class Loop:
    """One level of one dimension.  ``extent`` is cumulative (paper §3.1)."""

    dim: Dim
    extent: int

    def __repr__(self) -> str:
        return f"{self.dim.value}{self.extent}"


@dataclasses.dataclass(frozen=True)
class Extents:
    """Cumulative extents covered below some point in the string."""

    X: int = 1
    Y: int = 1
    C: int = 1
    K: int = 1
    Fw: int = 1
    Fh: int = 1
    N: int = 1

    def get(self, d: Dim) -> int:
        return getattr(self, d.value if d.value in ("Fw", "Fh") else d.name)

    def with_dim(self, d: Dim, value: int) -> "Extents":
        field = d.value if d.value in ("Fw", "Fh") else d.name
        return dataclasses.replace(self, **{field: value})

    def input_footprint(self, stride: int = 1) -> int:
        """Input elements touched (with halo)."""
        ix = (self.X - 1) * stride + self.Fw
        iy = (self.Y - 1) * stride + self.Fh
        return self.N * ix * iy * self.C

    def weight_footprint(self) -> int:
        return self.Fw * self.Fh * self.C * self.K

    def output_footprint(self) -> int:
        return self.N * self.X * self.Y * self.K


class BlockingString:
    """An ordered (inner -> outer) sequence of loops covering a Problem."""

    def __init__(self, loops: Sequence[Loop], problem: Problem):
        self.loops: tuple[Loop, ...] = tuple(loops)
        self.problem = problem
        self._validate()
        self._precompute()

    def _precompute(self) -> None:
        """Cache per-position extents, trip counts and suffix products —
        the access model queries these millions of times during search."""
        n = len(self.loops)
        cur = {d: 1 for d in Dim}
        self._extents: list[Extents] = []
        self._iters: list[int] = []
        for lp in self.loops:
            self._extents.append(Extents(
                X=cur[Dim.X], Y=cur[Dim.Y], C=cur[Dim.C], K=cur[Dim.K],
                Fw=cur[Dim.FW], Fh=cur[Dim.FH], N=cur[Dim.N]))
            self._iters.append(lp.extent // cur[lp.dim])
            cur[lp.dim] = lp.extent
        self._extents.append(Extents(
            X=cur[Dim.X], Y=cur[Dim.Y], C=cur[Dim.C], K=cur[Dim.K],
            Fw=cur[Dim.FW], Fh=cur[Dim.FH], N=cur[Dim.N]))
        # suffix products of trip counts: _suffix[q] = prod_{i>=q} iters(i)
        self._suffix: list[int] = [1] * (n + 1)
        for q in range(n - 1, -1, -1):
            self._suffix[q] = self._iters[q] * self._suffix[q + 1]

    # -- construction helpers -------------------------------------------------

    @classmethod
    def parse(cls, text: str, problem: Problem) -> "BlockingString":
        """Parse ``"Fw3 Fh3 X8 C64 K16 X56 C256 K512"`` style strings."""
        loops = []
        for tok in text.split():
            for d in sorted(Dim, key=lambda d: -len(d.value)):
                if tok.startswith(d.value) and tok[len(d.value):].isdigit():
                    loops.append(Loop(d, int(tok[len(d.value):])))
                    break
            else:
                raise ValueError(f"cannot parse loop token {tok!r}")
        return cls(loops, problem)

    def _validate(self) -> None:
        cur: dict[Dim, int] = {d: 1 for d in Dim}
        for lp in self.loops:
            if lp.extent < cur[lp.dim]:
                raise ValueError(
                    f"loop {lp} shrinks dimension (have {cur[lp.dim]})")
            if lp.extent % cur[lp.dim] != 0:
                raise ValueError(
                    f"loop {lp} extent not a multiple of inner extent "
                    f"{cur[lp.dim]}")
            cur[lp.dim] = lp.extent
        for d in Dim:
            full = self.problem.full_extent(d)
            if cur[d] != full:
                raise ValueError(
                    f"dimension {d.value} covered to {cur[d]} != {full}; "
                    "string must cover the whole problem")

    # -- queries ---------------------------------------------------------------

    def __repr__(self) -> str:
        return " ".join(repr(l) for l in self.loops)

    def __len__(self) -> int:
        return len(self.loops)

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, BlockingString)
                and self.loops == other.loops
                and self.problem == other.problem)

    def __hash__(self) -> int:
        return hash((self.loops, self.problem))

    def extents_below(self, pos: int) -> Extents:
        """Cumulative extents covered by loops strictly below ``pos``."""
        return self._extents[pos]

    def iterations(self, pos: int) -> int:
        """Trip count of the loop at ``pos``."""
        return self._iters[pos]

    def prod_iterations_from(self, start: int) -> int:
        """Product of trip counts of loops at positions >= ``start``."""
        return self._suffix[start]

    def total_iterations(self) -> int:
        return self._suffix[0]


# -- candidate generation ------------------------------------------------------

def divisors(n: int) -> list[int]:
    out = []
    i = 1
    while i * i <= n:
        if n % i == 0:
            out.append(i)
            if i != n // i:
                out.append(n // i)
        i += 1
    return sorted(out)


def near_divisors(n: int, max_count: int = 12) -> list[int]:
    """A trimmed set of divisors, biased toward powers of two & extremes."""
    divs = divisors(n)
    if len(divs) <= max_count:
        return divs
    keep = {1, n}
    pow2 = [d for d in divs if d & (d - 1) == 0]
    keep.update(pow2)
    # fill remaining slots evenly across the sorted divisor list
    step = max(1, len(divs) // max_count)
    keep.update(divs[::step])
    return sorted(keep)[:max_count] if len(keep) > max_count else sorted(keep)


def enumerate_orders(dims: Sequence[Dim]) -> Iterable[tuple[Dim, ...]]:
    """All distinct loop-dim orders (inner -> outer)."""
    seen = set()
    for perm in itertools.permutations(dims):
        if perm not in seen:
            seen.add(perm)
            yield perm
