// Flash-attention forward for Hopper: the port of
// repro/kernels/flash_attention.py::_flash_forward (pallas_call at :234).
//
// q (B, Sq, Hq, D), k and v (B, Skv, Hkv, D), out like q; GQA is indexed
// natively (query head h reads kv head h / G) where the JAX op vmapped a
// one-head kernel over batch, kv head and group.  Queries align to the
// tail of the keys (kv_offset = Skv - Sq); ragged Sq and Skv edges are
// masked here, so every shape launches and nothing falls back.  When the
// caller asks for it (training: the backward's residual), each finished
// row also writes lse = m + log(l), fp32, laid out (B, Hq, Sq); a row
// that sees no key writes 1e30 (the JAX kernel's BIG), so the backward's
// exp(s - lse) is 0 there.  The serving joins pass no lse pointer.
//
// Bound on this card: at the serving join shapes (Sq = Skv <= 512, D = 128)
// the work is 4 * Sq * Skv * Hq * D flops over a few MB, far below the
// H100's 295 flop/byte ridge -- bytes bound.  The design reads each K/V
// row once per block of kWarps query rows, all G heads of a kv head
// sharing the tile, and skips keys past the causal limit of the block's
// last row and before the window of its first.  Scores run on CUDA cores
// in fp32 (no wgmma yet; see attn_rows.cuh), over 32-key tiles; the
// blocking model's flash_tiles choice is not ported yet.
#include "attn_rows.cuh"

namespace {

struct DenseLayout {
  int sq, skv, hq, hkv, groups;
  float* lse;  // (B, Hq, Sq) fp32, or null
  __host__ __device__ int rows() const { return sq * groups; }
  __device__ int64_t q_row(int b, int hk, int t) const {
    return (int64_t(b) * sq + t / groups) * hq + hk * groups + t % groups;
  }
  __device__ int qpos(int, int t) const { return t / groups + (skv - sq); }
  __device__ int kv_len(int) const { return skv; }
  __device__ int64_t k_row(int b, int hk, int kpos) const {
    return (int64_t(b) * skv + kpos) * hkv + hk;
  }
  __device__ void row_stats(int b, int hk, int t, float m, float l) const {
    if (lse == nullptr) return;
    lse[(int64_t(b) * hq + hk * groups + t % groups) * sq + t / groups] =
        l == 0.f ? attn::kBig : m + logf(l);
  }
};

}  // namespace

// lse: (B, Hq, Sq) fp32 to fill, or null.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   void* lse, int batch, int sq, int skv,
                                   int hq, int hkv, int causal, int window,
                                   float logit_cap, void* stream) {
  if (hkv <= 0 || hq % hkv) return static_cast<int>(cudaErrorInvalidValue);
  const DenseLayout lay{sq, skv, hq, hkv, hq / hkv,
                        static_cast<float*>(lse)};
  const attn::Mask mk{causal, window, 1.0f / sqrtf(float(head_dim)),
                      logit_cap};
  return attn::dispatch(dtype, head_dim, lay, hkv, batch, q, k, v, o, mk,
                        attn::kDenseTile, static_cast<cudaStream_t>(stream));
}
