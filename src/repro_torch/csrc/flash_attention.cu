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
// A block owns block_q rows of one (batch, kv head), position-major over
// the G query heads (DenseLayout::q_row), so one K/V tile serves all G
// heads, and walks the keys its rows can see in tiles of block_kv: it
// skips tiles past the causal limit of its last row and before the
// window of its first.  (block_q, block_kv) come from
// core.hopper_adapter.flash_tiles, shared with the backward.
//
// head_dim: any multiple of 16 up to 256, at the smallest compiled width
// D of 32, 64, 128, 256 at least it (attn_rows.cuh: with_head_dim; the
// columns past head_dim stage as zeros and are not stored).
//
// bf16 (fwd_mma_kernel): the tensor cores.  block_q / 16 warps, each
// owning one m16 tile of rows; q is staged once (in the second K/V stage,
// so three blocks fit an SM at (64, 64)) and, up to D = 128, held in
// registers as A fragments for the whole KV loop (at D = 256 they would
// take 64 registers a thread: q stays in its own shared tile and its
// fragments are read at every KV tile); K and V tiles come in with 16-byte
// cp.async, two stages deep, XOR-swizzled; S = q . k^T takes K through
// ldmatrix, O += P . V takes V through ldmatrix.trans; the online softmax
// runs on the C fragments (attn_mma.cuh) and P goes to bf16 A fragments
// in registers.  Only tiles that cross a mask edge (the diagonal, the
// window, a ragged end) or carry a cap pay for the per-element mask.
// Blocks are issued last rows first, so the causal blocks with the most
// keys start earliest.
// fp32 (attn_rows_kernel): CUDA cores, kWarps rows a block, one row per
// warp, over block_kv-key tiles (TF32 would break the fp32 tolerances).
//
// Bound on this card: at the training shape (B 4, S 512, 32/8 heads,
// D 128, causal) the work is 4 * pairs * D = 8.6 GFLOP over 21 MB --
// operations bound on the tensor cores (0.0087 ms at 989 TFLOP/s) but
// close to the bytes (0.0063 ms); the join (B 1, S 64) is bytes bound.
// mma.sync reaches a fraction of the card's wgmma peak, and each warp
// re-reads the K/V tiles from shared memory: 16 flops per byte read.
#include "attn_mma.cuh"

namespace {

using attn_mma::bf16;

// Row t of a (batch, kv head)'s query stream is position t / G, head
// hk * G + t % G (G = groups, divided by gdiv).
struct DenseLayout {
  int sq, skv, hq, hkv, groups;
  float* lse;  // (B, Hq, Sq) fp32, or null
  attn_mma::FastDiv gdiv;
  __host__ __device__ int rows() const { return sq * groups; }
  __device__ int64_t q_row(int b, int hk, int t) const {
    const int p = gdiv.div(t);
    return (int64_t(b) * sq + p) * hq + hk * groups + (t - p * groups);
  }
  __device__ int qpos(int, int t) const { return gdiv.div(t) + (skv - sq); }
  __device__ int kv_len(int) const { return skv; }
  __device__ int64_t k_row(int b, int hk, int kpos) const {
    return (int64_t(b) * skv + kpos) * hkv + hk;
  }
  __device__ void row_stats(int b, int hk, int t, float m, float l) const {
    if (lse == nullptr) return;
    const int p = gdiv.div(t);
    lse[(int64_t(b) * hq + hk * groups + (t - p * groups)) * sq + p] =
        l == 0.f ? attn::kBig : m + logf(l);
  }
};

// grid (ceil(Sq * G / BQ), Hkv, B), BQ / 16 warps
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(2 * BQ)
fwd_mma_kernel(DenseLayout lay, const bf16* __restrict__ q,
               const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, attn::Mask mk) {
  constexpr int kThreads = 2 * BQ, NT = BKV / 8, DT = D / 8, KD = D / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = 2 * BKV * D;               // K and V of a stage
  bf16* const St = reinterpret_cast<bf16*>(smem);   // [2][K, V][BKV][D]
  bf16* const Qs =                                  // [BQ][D]
      St + (BQ <= kStage / D && attn_mma::fwd_q_in_regs<D>() ? kStage
                                                           : 2 * kStage);

  const int b = blockIdx.z, hk = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = lay.rows(), kv_len = lay.kv_len(b);
  const int t_last = min(t0 + BQ, rows) - 1;

  const int hd = mk.hd, hc = hd / 8;
  attn_mma::stage_rows<D, kThreads, BQ, false>(
      Qs, q, nullptr, nullptr, hc, [&](int r) -> int64_t {
        return t0 + r < rows ? lay.q_row(b, hk, t0 + r) * hd : -1;
      });
  attn::cp_async_commit();

  int k_hi = kv_len;
  if (mk.causal) k_hi = min(k_hi, lay.qpos(b, t_last) + 1);
  const int k_lo = mk.window > 0 ? max(0, lay.qpos(b, t0) - mk.window + 1)
                                 : 0;
  // stage s <- keys c0 .. c0 + BKV; keys at or past k_hi are zero
  auto load_tile = [&](int s, int c0) {
    attn_mma::stage_rows<D, kThreads, BKV, true>(
        St + s * kStage, k, St + s * kStage + BKV * D, v, hc,
        [&](int j) -> int64_t {
          return c0 + j < k_hi ? lay.k_row(b, hk, c0 + j) * hd : -1;
        });
    attn::cp_async_commit();
  };
  const int c_first = (k_lo / BKV) * BKV;
  if (c_first < k_hi) load_tile(0, c_first);
  attn::cp_async_wait<0>();
  __syncthreads();

  const int m0 = warp * attn_mma::kRowsPerWarp;
  constexpr bool kQRegs = attn_mma::fwd_q_in_regs<D>();
  uint32_t qf[kQRegs ? KD : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int ks = 0; ks < KD; ++ks)
      attn_mma::ld_a<D>(qf[ks], Qs, m0, ks, lane);
    __syncthreads();  // every warp holds its q before stage 1 is overwritten
  }
  bool row_ok[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + m0 + (lane >> 2) + 8 * h;
    row_ok[h] = t < rows;
    qpos[h] = row_ok[h] ? lay.qpos(b, t) : 0;
  }
  // the warp's rows: all real, and their first and last positions
  const bool rows_full = t0 + m0 + attn_mma::kRowsPerWarp <= rows;
  const int qpos_lo = lay.qpos(b, min(t0 + m0, rows - 1));
  const int qpos_hi = lay.qpos(b, min(t0 + m0 + 15, rows - 1));
  const float scale_log2 = mk.scale * attn_mma::kLog2e;

  float acc[DT][4] = {};
  float m[2] = {attn::kNegInf, attn::kNegInf}, l[2] = {0.f, 0.f};
  int s = 0;
  for (int c0 = c_first; c0 < k_hi; c0 += BKV, s ^= 1) {
    if (c0 + BKV < k_hi) {
      load_tile(s ^ 1, c0 + BKV);   // in flight while this tile is scored
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed for every thread
    const bf16* ks = St + s * kStage;
    const bf16* vs = ks + BKV * D;
    float sc[NT][4] = {};
    if constexpr (kQRegs)
      attn_mma::mma_abt_reg<D, NT>(sc, qf, ks, lane);
    else
      attn_mma::mma_abt<D, NT>(sc, Qs, m0, ks, lane);
    const bool masked =
        !(rows_full && c0 + BKV <= kv_len && mk.cap <= 0.f &&
          attn_mma::all_visible(mk, c0, c0 + BKV - 1, qpos_lo, qpos_hi));
    if (masked) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kpos = c0 + attn_mma::c_col(nt, e, lane);
          float tc;
          const float x = attn_mma::score(mk, sc[nt][e], &tc);
          const bool ok = row_ok[h] && kpos < kv_len &&
                          attn_mma::visible(mk, kpos, qpos[h]);
          sc[nt][e] = ok ? x * attn_mma::kLog2e : attn::kNegInf;
        }
    }
    attn_mma::softmax_update<NT, DT>(sc, masked ? 1.f : scale_log2, masked,
                                     m, l, acc);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t pa[4];
      attn_mma::c_to_a<NT>(pa, sc, j);
      attn_mma::mma_ab_step<D>(acc, pa, vs, 16 * j, lane);
    }
    __syncthreads();  // everyone is done with tile s before it is reused
  }

  bf16* out_row[2];
  float inv_l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + m0 + (lane >> 2) + 8 * h;
    l[h] = attn_mma::quad_sum(l[h]);
    inv_l[h] = 1.f / (l[h] == 0.f ? 1.f : l[h]);
    out_row[h] = row_ok[h] ? o + lay.q_row(b, hk, t) * hd : nullptr;
    if (row_ok[h] && (lane & 3) == 0)
      lay.row_stats(b, hk, t, m[h] * attn_mma::kLn2, l[h]);
  }
  attn_mma::store_rows<D>(acc, out_row, inv_l, hd, lane);
}

template <int D, int BQ, int BKV>
int launch_mma(const DenseLayout& lay, int batch, const void* q,
               const void* k, const void* v, void* o, const attn::Mask& mk,
               cudaStream_t stream) {
  const size_t smem = attn_mma::fwd_smem_bytes<D>(BQ, BKV);
  auto kernel = fwd_mma_kernel<D, BQ, BKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((lay.rows() + BQ - 1) / BQ, lay.hkv, batch);
  kernel<<<grid, 2 * BQ, smem, stream>>>(
      lay, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), mk);
  return static_cast<int>(cudaGetLastError());
}

// the (block_q, block_kv) pairs flash_tiles can return
// (flash_attention.MMA_TILES)
template <int D>
int dispatch_mma(int bq, int bkv, const DenseLayout& lay, int batch,
                 const void* q, const void* k, const void* v, void* o,
                 const attn::Mask& mk, cudaStream_t stream) {
#define FWD(BQ, BKV)                                                     \
  if (bq == BQ && bkv == BKV)                                            \
  return launch_mma<D, BQ, BKV>(lay, batch, q, k, v, o, mk, stream)
  FWD(16, 16); FWD(16, 32); FWD(16, 64);
  FWD(32, 16); FWD(32, 32); FWD(32, 64);
  FWD(64, 16); FWD(64, 32); FWD(64, 64);
#undef FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores, block_kv-key tiles), 1 = bfloat16
// (tensor cores, (block_q, block_kv) tiles).  lse: (B, Hq, Sq) fp32 to
// fill, or null.  Returns a cudaError_t.
extern "C" int flash_attention_fwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v, void* o,
                                   void* lse, int batch, int sq, int skv,
                                   int hq, int hkv, int causal, int window,
                                   float logit_cap, int block_q,
                                   int block_kv, void* stream) {
  if (hkv <= 0 || hq % hkv || block_q < 1 || block_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const DenseLayout lay{sq, skv, hq, hkv, hq / hkv,
                        static_cast<float*>(lse),
                        attn_mma::FastDiv(uint32_t(hq / hkv))};
  if (lay.rows() == 0 || batch == 0) return 0;
  if (!attn_mma::FastDiv::exact(lay.rows(), lay.groups))
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::Mask mk{causal, window, 1.0f / sqrtf(float(head_dim)),
                      logit_cap, head_dim};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return attn::launch_rows<float, D>(lay, hkv, batch, q, k, v, o, mk,
                                         block_kv, s);
    return dispatch_mma<D>(block_q, block_kv, lay, batch, q, k, v, o, mk, s);
  });
}
