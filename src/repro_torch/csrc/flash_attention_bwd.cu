// Flash-attention backward for Hopper: the port of
// repro/kernels/flash_attention_bwd.py::flash_attention_bwd (_dq_kernel
// and _dkv_kernel, pallas_calls at :134 and :148).
//
// The recompute backward: the forward saved only o and lse = m + log(l)
// per query row (flash_attention.cu, (B, Hq, Sq) fp32); each pass replays
// the scores it needs, p = exp(s - lse), and with delta = rowsum(do * o)
// forms ds = p * (dp - delta), dp = do . v, times 1 - t^2 under a logit
// cap (s = cap * t, t = tanh(s_pre / cap)).  JAX computes delta outside
// its kernels; here the dq pass, which stages each row's do anyway, sums
// it in fp32 and writes it for the dk/dv pass, launched after it on the
// same stream.  Layouts as the
// forward's: q, o, do (B, Sq, Hq, D), k, v (B, Skv, Hkv, D); dq, dk, dv
// like their inputs, in the input dtype.  Causal masking aligns queries to
// the tail of the keys (kv_offset = Skv - Sq); the window is the
// forward's.
//
// * dq pass (grid over query rows): a block runs kWarps query rows of one
//   (batch, kv head) -- the G heads folded in position-major, as in the
//   forward -- one row per warp, and streams the K and V rows they can see
//   in tiles of tile_kv keys, staged two deep with cp.async.  Lane j
//   scores keys j, j + 32, ... of the tile (q . k and do . v, each lane
//   starting the head dim at its own offset so 32 lanes on 32 key rows
//   read 32 banks), parks ds in shared memory, and the warp accumulates
//   dq += ds * k with lane j holding dims j, j + 32, ...
// * dk/dv pass (grid over keys): the same walk with the roles swapped.  A
//   block runs kWarps keys of one (batch, kv head), one key per warp, and
//   streams the query rows that can see them -- all G query heads of the
//   kv head, positions in order, (q, do, lse, delta) tiles of tile_q rows
//   -- accumulating dv += p * do and dk += ds * q.  GQA's sum over the G
//   heads happens here, inside the block, in one fixed order (position,
//   then head), where JAX let autodiff sum a vmapped one-head kernel: no
//   atomics, so repeated launches agree bit for bit.
//
// Two instances of each pass.  fp32 (dq_kernel, dkv_kernel): CUDA cores,
// as above, over the tiles' runtime lengths.  bf16 (dq_mma_kernel,
// dkv_mma_kernel): the tensor cores, every product an mma.sync m16n8k16
// with fp32 sums on the swizzled tiles of attn_mma.cuh; P and dS are
// rounded to bf16 on their way from C to A fragments, in registers.
// * dq: block_q / 16 warps, each owning one m16 tile of the block's
//   block_q rows (q, do staged once, with their lse and delta); K/V tiles
//   of block_kv keys, two stages deep.  Per tile S = q . k^T and
//   dP = do . v^T (K and V through ldmatrix), then dS, then
//   dq += dS . k (K through ldmatrix.trans).
// * dk/dv: block_kv / 16 warps, each owning one m16 tile of the block's
//   block_kv keys (k, v staged once); (q, do, lse, delta) tiles of
//   block_q rows -- all G heads, positions in order -- two stages deep,
//   scored kDkvSubRows rows at a time so the sums fit the registers:
//   S^T = k . q^T, dP^T = v . do^T, P^T and dS^T, then dv += P^T . do and
//   dk += dS^T . q (q and do through ldmatrix.trans).  The fragments of k
//   and v are re-read from shared memory per step, not held.  At D = 256
//   dk and dv together would need 272 sums a thread: the pass sweeps the
//   rows twice, dv first, then dk, 16 rows at a time (dkv_sweep), each
//   sweep recomputing s and p; the order is fixed, so repeats stay
//   bit-equal.
// head_dim: any multiple of 16 up to 256, at the smallest compiled width
// D of 32, 64, 128, 256 at least it (attn_rows.cuh: with_head_dim); the
// columns past head_dim stage as zeros and are not stored.
// Both are issued heaviest first (dq: the last rows; dk/dv: the first
// keys).  Seven products where the bound counts five: no closer than
// 1.4x the operations bound.
//
// Bound on this card: at the training shapes (Sq = Skv = 512, D = 128)
// the work, about 10 * Sq * Skv / 2 * Hq * D flops causal, is over the
// bf16 ridge only with tensor cores.  (block_q, block_kv) come from
// core.hopper_adapter.flash_tiles (the forward's too), checked against
// dq_smem_bytes / dkv_smem_bytes (mirrored in
// kernels/flash_attention_bwd.py) and the accumulator counts.
#include "attn_mma.cuh"

namespace {

using attn::kThreads;
using attn::kWarps;

struct BwdLayout {
  int sq, skv, hq, hkv, groups;
  attn_mma::FastDiv gdiv;   // divides by groups
  __device__ int rows() const { return sq * groups; }
  // row t of the (batch, kv head)'s query stream: position t / groups,
  // head hk * groups + t % groups
  __device__ int64_t q_row(int b, int hk, int t) const {
    const int p = gdiv.div(t);
    return (int64_t(b) * sq + p) * hq + hk * groups + (t - p * groups);
  }
  __device__ int64_t stat_row(int b, int hk, int t) const {
    const int p = gdiv.div(t);
    return (int64_t(b) * hq + hk * groups + (t - p * groups)) * sq + p;
  }
  __device__ int qpos(int t) const { return gdiv.div(t) + (skv - sq); }
  __device__ int64_t k_row(int b, int hk, int kpos) const {
    return (int64_t(b) * skv + kpos) * hkv + hk;
  }
};

// dot of the warp's row x with lane's row y (both in shared memory), each
// lane starting at its own head-dim offset
template <int D, typename T>
__device__ __forceinline__ float dot_rot(const T* x, const T* y, int lane) {
  constexpr int kRot = 4 / sizeof(T);
  float s = 0.f;
#pragma unroll 16
  for (int i = 0; i < D; ++i) {
    const int d = (i + kRot * lane) & (D - 1);
    s = fmaf(attn::to_f(x[d]), attn::to_f(y[d]), s);
  }
  return s;
}

// p and ds of one (query row, key) pair, the row's x . k already taken
struct Grad {
  float p, ds;
};
__device__ __forceinline__ Grad grad(const attn::Mask& mk, float s, float tc,
                                     float lse, float dp, float delta) {
  const float p = expf(s - lse);
  float ds = p * (dp - delta);
  if (mk.cap > 0.f) ds *= 1.f - tc * tc;
  return {p, ds};
}

template <typename T>
__host__ __device__ constexpr size_t dq_smem_bytes(int tile, int d) {
  return size_t(2) * 2 * tile * d * sizeof(T) +    // K, V: two stages
         size_t(2) * kWarps * d * sizeof(T) +      // q, do rows
         size_t(kWarps) * tile * sizeof(float);    // ds per warp
}

template <typename T>
__host__ __device__ constexpr size_t dkv_smem_bytes(int tile, int d) {
  return size_t(2) * 2 * tile * d * sizeof(T) +    // q, do: two stages
         size_t(2) * 2 * tile * sizeof(float) +    // lse, delta
         size_t(2) * kWarps * d * sizeof(T) +      // k, v rows
         size_t(2) * kWarps * tile * sizeof(float);  // p, ds per warp
}

// grid (ceil(Sq * G / kWarps), Hkv, B)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(BwdLayout lay, const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ go,
          const T* __restrict__ o, const float* __restrict__ lse,
          float* __restrict__ delta, T* __restrict__ dq, attn::Mask mk,
          int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = D / 32;
  constexpr int VEC = 16 / sizeof(T), VPR = D / VEC;
  T* const Ks = reinterpret_cast<T*>(smem);           // [2][tile][D]
  T* const Vs = Ks + 2 * tile * D;                    // [2][tile][D]
  T* const Qs = Vs + 2 * tile * D;                    // [kWarps][D]
  T* const Gs = Qs + kWarps * D;                      // [kWarps][D]
  float* const Ps = reinterpret_cast<float*>(Gs + kWarps * D);

  const int b = blockIdx.z, hk = blockIdx.y, t0 = blockIdx.x * kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = lay.rows();
  const int t = t0 + warp;
  const bool row_ok = t < rows;
  const int t_last = min(t0 + kWarps, rows) - 1;
  T* const qs = Qs + warp * D;
  T* const gs = Gs + warp * D;
  const int hd = mk.hd;
  float lse_t = 0.f, delta_t = 0.f;
  int qpos = 0;
  if (row_ok) {
    const int64_t r = lay.q_row(b, hk, t) * hd;
    for (int d = lane; d < D; d += 32) {
      const bool in = d < hd;
      qs[d] = in ? q[r + d] : attn::from_f<T>(0.f);
      gs[d] = in ? go[r + d] : attn::from_f<T>(0.f);
      if (in)
        delta_t = fmaf(attn::to_f(go[r + d]), attn::to_f(o[r + d]), delta_t);
    }
    delta_t = attn::warp_sum(delta_t);
    if (lane == 0) delta[lay.stat_row(b, hk, t)] = delta_t;
    lse_t = lse[lay.stat_row(b, hk, t)];
    qpos = lay.qpos(t);
  }
  int k_hi = lay.skv;
  if (mk.causal) k_hi = min(k_hi, lay.qpos(t_last) + 1);
  const int k_lo = mk.window > 0 ? max(0, lay.qpos(t0) - mk.window + 1) : 0;

  auto load_tile = [&](int s, int c0) {
    T* ks = Ks + s * tile * D;
    T* vs = Vs + s * tile * D;
    for (int idx = threadIdx.x; idx < tile * VPR; idx += kThreads) {
      const int j = idx / VPR, e = (idx % VPR) * VEC;
      if (c0 + j < k_hi && e < hd) {
        const int64_t off = lay.k_row(b, hk, c0 + j) * hd + e;
        attn::cp_async16(ks + j * D + e, k + off);
        attn::cp_async16(vs + j * D + e, v + off);
      } else {
        *reinterpret_cast<uint4*>(ks + j * D + e) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vs + j * D + e) = make_uint4(0, 0, 0, 0);
      }
    }
    attn::cp_async_commit();
  };

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  const int c_first = (k_lo / tile) * tile;
  if (c_first < k_hi) load_tile(0, c_first);
  float* const ps = Ps + warp * tile;
  int s = 0;
  for (int c0 = c_first; c0 < k_hi; c0 += tile, s ^= 1) {
    if (c0 + tile < k_hi) {
      load_tile(s ^ 1, c0 + tile);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed; the q and do rows are visible
    if (row_ok) {
      const T* ks = Ks + s * tile * D;
      const T* vs = Vs + s * tile * D;
      for (int j = lane; j < tile; j += 32) {
        const int kpos = c0 + j;
        float ds = 0.f;
        if (kpos < lay.skv && attn_mma::visible(mk, kpos, qpos)) {
          float tc;
          const float sc =
              attn_mma::score(mk, dot_rot<D>(qs, ks + j * D, lane), &tc);
          ds = grad(mk, sc, tc, lse_t, dot_rot<D>(gs, vs + j * D, lane),
                    delta_t).ds;
        }
        ps[j] = ds;
      }
      __syncwarp();
      const int n_keys = min(tile, k_hi - c0);
#pragma unroll 4
      for (int j = 0; j < n_keys; ++j) {
        const float dsj = ps[j];
        const T* kr = ks + j * D;
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = fmaf(dsj, attn::to_f(kr[lane + 32 * i]), acc[i]);
      }
      __syncwarp();
    }
    __syncthreads();  // tile s is free for the copy after next
  }
  if (row_ok) {
    const int64_t r = lay.q_row(b, hk, t) * hd;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (lane + 32 * i < hd)
        dq[r + lane + 32 * i] = attn::from_f<T>(acc[i] * mk.scale);
  }
}

// grid (ceil(Skv / kWarps), Hkv, B)
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(BwdLayout lay, const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ go,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dk, T* __restrict__ dv, attn::Mask mk, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = D / 32;
  constexpr int VEC = 16 / sizeof(T), VPR = D / VEC;
  T* const Qs = reinterpret_cast<T*>(smem);           // [2][tile][D]
  T* const Gs = Qs + 2 * tile * D;                    // [2][tile][D]
  // lse and delta of the staged rows, [2][tile] each
  float* const Ls = reinterpret_cast<float*>(Gs + 2 * tile * D);
  float* const Ds = Ls + 2 * tile;
  T* const Kw = reinterpret_cast<T*>(Ds + 2 * tile);  // [kWarps][D]
  T* const Vw = Kw + kWarps * D;                      // [kWarps][D]
  // p and ds of each warp's key against the staged rows, [kWarps][tile]
  float* const Pw = reinterpret_cast<float*>(Vw + kWarps * D);
  float* const Sw = Pw + kWarps * tile;

  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * kWarps;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int key = j0 + warp;
  const bool key_ok = key < lay.skv;
  const int j_last = min(j0 + kWarps, lay.skv) - 1;
  T* const kw = Kw + warp * D;
  T* const vw = Vw + warp * D;
  const int hd = mk.hd;
  if (key_ok) {
    const int64_t r = lay.k_row(b, hk, key) * hd;
    for (int d = lane; d < D; d += 32) {
      kw[d] = d < hd ? k[r + d] : attn::from_f<T>(0.f);
      vw[d] = d < hd ? v[r + d] : attn::from_f<T>(0.f);
    }
  }
  // the query rows some key of this block is visible to
  const int rows = lay.rows(), kv_off = lay.skv - lay.sq;
  int t_lo = 0, t_hi = rows;
  if (mk.causal) t_lo = min(rows, max(0, j0 - kv_off) * lay.groups);
  if (mk.window > 0)
    t_hi = min(rows, max(0, j_last + mk.window - kv_off) * lay.groups);

  auto load_tile = [&](int s, int c0) {
    T* qs = Qs + s * tile * D;
    T* gs = Gs + s * tile * D;
    for (int idx = threadIdx.x; idx < tile * VPR; idx += kThreads) {
      const int r = idx / VPR, e = (idx % VPR) * VEC;
      if (c0 + r < t_hi && e < hd) {
        const int64_t off = lay.q_row(b, hk, c0 + r) * hd + e;
        attn::cp_async16(qs + r * D + e, q + off);
        attn::cp_async16(gs + r * D + e, go + off);
      } else {
        *reinterpret_cast<uint4*>(qs + r * D + e) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(gs + r * D + e) = make_uint4(0, 0, 0, 0);
      }
    }
    for (int r = threadIdx.x; r < tile; r += kThreads) {
      const bool in = c0 + r < t_hi;
      Ls[s * tile + r] = in ? lse[lay.stat_row(b, hk, c0 + r)] : 0.f;
      Ds[s * tile + r] = in ? delta[lay.stat_row(b, hk, c0 + r)] : 0.f;
    }
    attn::cp_async_commit();
  };

  float acc_k[P], acc_v[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (t_lo < t_hi) load_tile(0, t_lo);
  float* const pw = Pw + warp * tile;
  float* const sw = Sw + warp * tile;
  int s = 0;
  for (int c0 = t_lo; c0 < t_hi; c0 += tile, s ^= 1) {
    if (c0 + tile < t_hi) {
      load_tile(s ^ 1, c0 + tile);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed; the k and v rows are visible
    if (key_ok) {
      const T* qs = Qs + s * tile * D;
      const T* gs = Gs + s * tile * D;
      for (int r = lane; r < tile; r += 32) {
        const int t = c0 + r;
        Grad gr{0.f, 0.f};
        if (t < t_hi && attn_mma::visible(mk, key, lay.qpos(t))) {
          float tc;
          const float sc =
              attn_mma::score(mk, dot_rot<D>(kw, qs + r * D, lane), &tc);
          gr = grad(mk, sc, tc, Ls[s * tile + r],
                    dot_rot<D>(vw, gs + r * D, lane), Ds[s * tile + r]);
        }
        pw[r] = gr.p;
        sw[r] = gr.ds;
      }
      __syncwarp();
      const int n_rows = min(tile, t_hi - c0);
#pragma unroll 4
      for (int r = 0; r < n_rows; ++r) {
        const float pr = pw[r], dsr = sw[r];
        const T* qr = qs + r * D;
        const T* gr = gs + r * D;
#pragma unroll
        for (int i = 0; i < P; ++i) {
          acc_v[i] = fmaf(pr, attn::to_f(gr[lane + 32 * i]), acc_v[i]);
          acc_k[i] = fmaf(dsr, attn::to_f(qr[lane + 32 * i]), acc_k[i]);
        }
      }
      __syncwarp();
    }
    __syncthreads();
  }
  if (key_ok) {
    const int64_t r = lay.k_row(b, hk, key) * hd;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (lane + 32 * i >= hd) continue;
      dk[r + lane + 32 * i] = attn::from_f<T>(acc_k[i] * mk.scale);
      dv[r + lane + 32 * i] = attn::from_f<T>(acc_v[i]);
    }
  }
}

// ---- bf16: the tensor-core passes ------------------------------------

using attn_mma::bf16;

// grid (ceil(Sq * G / BQ), Hkv, B), BQ / 16 warps
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(2 * BQ)
dq_mma_kernel(BwdLayout lay, const bf16* __restrict__ q,
              const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ go, const bf16* __restrict__ o,
              const float* __restrict__ lse, float* __restrict__ delta,
              bf16* __restrict__ dq, attn::Mask mk) {
  constexpr int kThreads = 2 * BQ, NT = BKV / 8, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Qs = reinterpret_cast<bf16*>(smem);   // [BQ][D]
  bf16* const Gs = Qs + BQ * D;                     // [BQ][D]
  bf16* const Ks = Gs + BQ * D;                     // [2][BKV][D]
  bf16* const Vs = Ks + 2 * BKV * D;                // [2][BKV][D]
  float* const Ls = reinterpret_cast<float*>(Vs + 2 * BKV * D);  // [BQ]
  float* const Ds = Ls + BQ;                                     // [BQ]

  const int b = blockIdx.z, hk = blockIdx.y;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = lay.rows();
  const int t_last = min(t0 + BQ, rows) - 1;

  const int hd = mk.hd, hc = hd / 8;
  attn_mma::stage_rows<D, kThreads, BQ, true>(
      Qs, q, Gs, go, hc, [&](int r) -> int64_t {
        return t0 + r < rows ? lay.q_row(b, hk, t0 + r) * hd : -1;
      });
  for (int r = threadIdx.x; r < BQ; r += kThreads)
    Ls[r] = t0 + r < rows
                ? lse[lay.stat_row(b, hk, t0 + r)] * attn_mma::kLog2e
                : 0.f;
  attn::cp_async_commit();

  int k_hi = lay.skv;
  if (mk.causal) k_hi = min(k_hi, lay.qpos(t_last) + 1);
  const int k_lo = mk.window > 0 ? max(0, lay.qpos(t0) - mk.window + 1) : 0;
  auto load_tile = [&](int s, int c0) {
    attn_mma::stage_rows<D, kThreads, BKV, true>(
        Ks + s * BKV * D, k, Vs + s * BKV * D, v, hc, [&](int j) -> int64_t {
          return c0 + j < k_hi ? lay.k_row(b, hk, c0 + j) * hd : -1;
        });
    attn::cp_async_commit();
  };
  const int c_first = (k_lo / BKV) * BKV;
  if (c_first < k_hi) load_tile(0, c_first);
  attn::cp_async_wait<0>();
  __syncthreads();  // q, do and lse are visible

  // delta = rowsum(do * o) of the warp's rows in fp32: here, and in
  // global memory for the dk/dv pass that follows on the stream
  const int m0 = warp * attn_mma::kRowsPerWarp;
  {
    // two lanes a row, half a row each, every 16-byte load of o in flight
    // at once; the halves add in a fixed order (chunks past head_dim are
    // zero in do and not read from o)
    constexpr int CH = D / 16;               // 16-byte chunks per half row
    const int r = m0 + (lane >> 1), half = lane & 1;
    const bool in = t0 + r < rows;
    float d = 0.f;
    if (in) {
      const uint4* orow = reinterpret_cast<const uint4*>(
                              o + lay.q_row(b, hk, t0 + r) * hd) + half * CH;
      uint4 ov[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c)
        ov[c] = half * CH + c < hc ? orow[c] : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 gv = *reinterpret_cast<const uint4*>(
            Gs + attn_mma::swz<D>(r, half * CH + c));
        const auto* op = reinterpret_cast<const __nv_bfloat162*>(&ov[c]);
        const auto* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(op[j]);
          const float2 gf = __bfloat1622float2(gp[j]);
          d = fmaf(of.x, gf.x, fmaf(of.y, gf.y, d));
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      Ds[r] = d;
      if (in) delta[lay.stat_row(b, hk, t0 + r)] = d;
    }
  }
  __syncwarp();  // the warp's delta rows are visible to the warp
  bool row_ok[2];
  int qpos[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = m0 + (lane >> 2) + 8 * h;
    row_ok[h] = t0 + r < rows;
    qpos[h] = row_ok[h] ? lay.qpos(t0 + r) : 0;
    lse2[h] = Ls[r];
    dl[h] = Ds[r];
  }
  const bool rows_full = t0 + m0 + attn_mma::kRowsPerWarp <= rows;
  const int qpos_lo = lay.qpos(min(t0 + m0, rows - 1));
  const int qpos_hi = lay.qpos(min(t0 + m0 + 15, rows - 1));
  const float scale_log2 = mk.scale * attn_mma::kLog2e;

  float acc[DT][4] = {};
  int s = 0;
  for (int c0 = c_first; c0 < k_hi; c0 += BKV, s ^= 1) {
    if (c0 + BKV < k_hi) {
      load_tile(s ^ 1, c0 + BKV);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed for every thread
    const bf16* ks = Ks + s * BKV * D;
    const bf16* vs = Vs + s * BKV * D;
    float sc[NT][4] = {}, dp[NT][4] = {};
    attn_mma::mma_abt<D, NT>(sc, Qs, m0, ks, lane);
    attn_mma::mma_abt<D, NT>(dp, Gs, m0, vs, lane);
    if (rows_full && c0 + BKV <= lay.skv && mk.cap <= 0.f &&
        attn_mma::all_visible(mk, c0, c0 + BKV - 1, qpos_lo, qpos_hi)) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p =
              attn_mma::exp2_ftz(fmaf(sc[nt][e], scale_log2, -lse2[h]));
          dp[nt][e] = p * (dp[nt][e] - dl[h]);
        }
    } else {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, kpos = c0 + attn_mma::c_col(nt, e, lane);
          float tc;
          const float x = attn_mma::score(mk, sc[nt][e], &tc);
          const bool ok = row_ok[h] && kpos < lay.skv &&
                          attn_mma::visible(mk, kpos, qpos[h]);
          const float p =
              ok ? attn_mma::exp2_ftz(x * attn_mma::kLog2e - lse2[h]) : 0.f;
          float ds = p * (dp[nt][e] - dl[h]);
          if (mk.cap > 0.f) ds *= 1.f - tc * tc;
          dp[nt][e] = ds;
        }
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t da[4];
      attn_mma::c_to_a<NT>(da, dp, j);
      attn_mma::mma_ab_step<D>(acc, da, ks, 16 * j, lane);
    }
    __syncthreads();  // tile s is free for the copy after next
  }
  bf16* out_row[2];
  const float mul[2] = {mk.scale, mk.scale};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + m0 + (lane >> 2) + 8 * h;
    out_row[h] = row_ok[h] ? dq + lay.q_row(b, hk, t) * hd : nullptr;
  }
  attn_mma::store_rows<D>(acc, out_row, mul, hd, lane);
}

// Rows scored at once by the dk/dv pass, and its sweeps over the rows:
// up to D = 128 one sweep sums dk and dv together, 32 rows at a time; at
// D = 256 the two would need 16 (2 D + 2 rows) / 32 = 272 sums a thread,
// so a first sweep sums dv and a second dk, 16 rows at a time (144 sums;
// each recomputes s and p).  kernels/flash_attention_bwd.py::
// dkv_sub_rows and dkv_sweeps.
template <int D> __host__ __device__ constexpr int dkv_sweeps() {
  return D > 128 ? 2 : 1;
}
template <int D, int BQ> __host__ __device__ constexpr int dkv_sub_rows() {
  constexpr int RS = D > 128 ? 16 : attn_mma::kDkvSubRows;
  return BQ < RS ? BQ : RS;
}

// One sweep of the dk/dv pass over the (q, do, lse, delta) tiles the
// block's keys can see: dv += P^T . do (kV) and dk += dS^T . q (kK).
template <int D, int BQ, int BKV, bool kK, bool kV>
__device__ __forceinline__ void dkv_sweep(
    const BwdLayout& lay, const bf16* __restrict__ q,
    const bf16* __restrict__ go, const float* __restrict__ lse,
    const float* __restrict__ delta, const attn::Mask& mk,
    unsigned char* smem, int b, int hk, int j0, int t_lo, int t_hi,
    float (&acc_k)[D / 8][4], float (&acc_v)[D / 8][4]) {
  constexpr int kThreads = 2 * BKV;
  constexpr int RS = dkv_sub_rows<D, BQ>(), NTS = RS / 8;
  bf16* const Kw = reinterpret_cast<bf16*>(smem);   // [BKV][D]
  bf16* const Vw = Kw + BKV * D;                    // [BKV][D]
  bf16* const Qs = Vw + BKV * D;                    // [2][BQ][D]
  bf16* const Gs = Qs + 2 * BQ * D;                 // [2][BQ][D]
  // the staged rows' lse (natural units) and delta
  float* const Ls = reinterpret_cast<float*>(Gs + 2 * BQ * D);  // [2][BQ]
  float* const Ds = Ls + 2 * BQ;                                 // [2][BQ]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = mk.hd, hc = hd / 8;

  auto load_tile = [&](int s, int c0) {
    attn_mma::stage_rows<D, kThreads, BQ, true>(
        Qs + s * BQ * D, q, Gs + s * BQ * D, go, hc,
        [&](int r) -> int64_t {
          return c0 + r < t_hi ? lay.q_row(b, hk, c0 + r) * hd : -1;
        });
    for (int r = threadIdx.x; r < BQ; r += kThreads) {
      float* const lr = Ls + s * BQ + r;
      float* const dr = Ds + s * BQ + r;
      if (c0 + r < t_hi) {
        const int64_t i = lay.stat_row(b, hk, c0 + r);
        attn_mma::cp_async4(lr, lse + i);
        attn_mma::cp_async4(dr, delta + i);
      } else {
        *lr = 0.f;
        *dr = 0.f;
      }
    }
    attn::cp_async_commit();
  };
  if (t_lo < t_hi) load_tile(0, t_lo);
  attn::cp_async_wait<0>();
  __syncthreads();  // k and v are visible

  const int m0 = warp * attn_mma::kRowsPerWarp;
  bool key_ok[2];
  int key[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = j0 + m0 + (lane >> 2) + 8 * h;
    key_ok[h] = key[h] < lay.skv;
  }

  const bool keys_full = j0 + m0 + attn_mma::kRowsPerWarp <= lay.skv;
  const int key_lo = j0 + m0, key_hi = j0 + m0 + 15;
  const float scale_log2 = mk.scale * attn_mma::kLog2e;
  int s = 0;
  for (int c0 = t_lo; c0 < t_hi; c0 += BQ, s ^= 1) {
    if (c0 + BQ < t_hi) {
      load_tile(s ^ 1, c0 + BQ);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed for every thread
    for (int rs = 0; rs < BQ && c0 + rs < t_hi; rs += RS) {
      const bf16* qs = Qs + (s * BQ + rs) * D;
      const bf16* gs = Gs + (s * BQ + rs) * D;
      const float* ls = Ls + s * BQ + rs;
      const float* dls = Ds + s * BQ + rs;
      float st[NTS][4] = {}, dpt[kK ? NTS : 1][4] = {};
      attn_mma::mma_abt<D, NTS>(st, Kw, m0, qs, lane);    // S^T = k q^T
      if constexpr (kK)
        attn_mma::mma_abt<D, NTS>(dpt, Vw, m0, gs, lane);  // dP^T = v do^T
      const int t_first = c0 + rs, t_end = t_first + RS;
      if (keys_full && t_end <= t_hi && mk.cap <= 0.f &&
          attn_mma::all_visible(mk, key_lo, key_hi, lay.qpos(t_first),
                                lay.qpos(t_end - 1))) {
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = attn_mma::c_col(nt, e, lane);
            const float p = attn_mma::exp2_ftz(
                fmaf(st[nt][e], scale_log2, -ls[r] * attn_mma::kLog2e));
            st[nt][e] = p;
            if constexpr (kK) dpt[nt][e] = p * (dpt[nt][e] - dls[r]);
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < NTS; ++nt)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int r = attn_mma::c_col(nt, c, lane), t = c0 + rs + r;
            const bool row_in = t < t_hi;
            const int qpos = lay.qpos(t);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int e = 2 * h + c;
              float tc;
              const float x = attn_mma::score(mk, st[nt][e], &tc);
              const bool ok = row_in && key_ok[h] &&
                              attn_mma::visible(mk, key[h], qpos);
              const float p =
                  ok ? attn_mma::exp2_ftz((x - ls[r]) * attn_mma::kLog2e)
                     : 0.f;
              st[nt][e] = p;
              if constexpr (kK) {
                float ds = p * (dpt[nt][e] - dls[r]);
                if (mk.cap > 0.f) ds *= 1.f - tc * tc;
                dpt[nt][e] = ds;
              }
            }
          }
      }
#pragma unroll
      for (int j = 0; j < NTS / 2; ++j) {
        uint32_t pa[4];
        if constexpr (kV) {
          attn_mma::c_to_a<NTS>(pa, st, j);
          attn_mma::mma_ab_step<D>(acc_v, pa, gs, 16 * j, lane);
        }
        if constexpr (kK) {
          attn_mma::c_to_a<NTS>(pa, dpt, j);
          attn_mma::mma_ab_step<D>(acc_k, pa, qs, 16 * j, lane);
        }
      }
    }
    __syncthreads();  // tile s is free for the copy after next
  }
}

// grid (ceil(Skv / BKV), Hkv, B), BKV / 16 warps
template <int D, int BQ, int BKV>
__global__ void __launch_bounds__(2 * BKV)
dkv_mma_kernel(BwdLayout lay, const bf16* __restrict__ q,
               const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ go, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk,
               bf16* __restrict__ dv, attn::Mask mk) {
  constexpr int kThreads = 2 * BKV, DT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* const Kw = reinterpret_cast<bf16*>(smem);   // [BKV][D]
  bf16* const Vw = Kw + BKV * D;                    // [BKV][D]

  const int b = blockIdx.z, hk = blockIdx.y, j0 = blockIdx.x * BKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j_last = min(j0 + BKV, lay.skv) - 1;
  const int hd = mk.hd;
  attn_mma::stage_rows<D, kThreads, BKV, true>(
      Kw, k, Vw, v, hd / 8, [&](int j) -> int64_t {
        return j0 + j < lay.skv ? lay.k_row(b, hk, j0 + j) * hd : -1;
      });
  attn::cp_async_commit();

  // the query rows some key of this block is visible to
  const int rows = lay.rows(), kv_off = lay.skv - lay.sq;
  int t_lo = 0, t_hi = rows;
  if (mk.causal) t_lo = min(rows, max(0, j0 - kv_off) * lay.groups);
  if (mk.window > 0)
    t_hi = min(rows, max(0, j_last + mk.window - kv_off) * lay.groups);

  bf16* k_row[2];
  bf16* v_row[2];
  const int m0 = warp * attn_mma::kRowsPerWarp;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = j0 + m0 + (lane >> 2) + 8 * h;
    const int64_t r = lay.k_row(b, hk, key) * hd;
    k_row[h] = key < lay.skv ? dk + r : nullptr;
    v_row[h] = key < lay.skv ? dv + r : nullptr;
  }
  const float k_mul[2] = {mk.scale, mk.scale}, v_mul[2] = {1.f, 1.f};
  if constexpr (dkv_sweeps<D>() == 1) {
    float acc_k[DT][4] = {}, acc_v[DT][4] = {};
    dkv_sweep<D, BQ, BKV, true, true>(lay, q, go, lse, delta, mk, smem, b,
                                      hk, j0, t_lo, t_hi, acc_k, acc_v);
    attn_mma::store_rows<D>(acc_k, k_row, k_mul, hd, lane);
    attn_mma::store_rows<D>(acc_v, v_row, v_mul, hd, lane);
  } else {
    float acc[DT][4] = {};
    dkv_sweep<D, BQ, BKV, false, true>(lay, q, go, lse, delta, mk, smem, b,
                                       hk, j0, t_lo, t_hi, acc, acc);
    attn_mma::store_rows<D>(acc, v_row, v_mul, hd, lane);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
    dkv_sweep<D, BQ, BKV, true, false>(lay, q, go, lse, delta, mk, smem, b,
                                       hk, j0, t_lo, t_hi, acc, acc);
    attn_mma::store_rows<D>(acc, k_row, k_mul, hd, lane);
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

struct Args {
  BwdLayout lay;
  int batch;
  const void *q, *k, *v, *go, *o;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  attn::Mask mk;
  cudaStream_t stream;
};

// fp32: the CUDA-core passes over tile_q rows (dk/dv) and tile_kv keys
// (dq)
template <int D>
int launch_fp32(const Args& a, int tile_q, int tile_kv) {
  const float* Q = static_cast<const float*>(a.q);
  const float* K = static_cast<const float*>(a.k);
  const float* V = static_cast<const float*>(a.v);
  const float* G = static_cast<const float*>(a.go);
  const size_t smem_q = dq_smem_bytes<float>(tile_kv, D);
  int e = allow_smem(dq_kernel<float, D>, smem_q);
  if (e) return e;
  const dim3 grid_q((a.lay.sq * a.lay.groups + kWarps - 1) / kWarps,
                    a.lay.hkv, a.batch);
  dq_kernel<float, D><<<grid_q, kThreads, smem_q, a.stream>>>(
      a.lay, Q, K, V, G, static_cast<const float*>(a.o), a.lse, a.delta,
      static_cast<float*>(a.dq), a.mk, tile_kv);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t smem_kv = dkv_smem_bytes<float>(tile_q, D);
  e = allow_smem(dkv_kernel<float, D>, smem_kv);
  if (e) return e;
  const dim3 grid_kv((a.lay.skv + kWarps - 1) / kWarps, a.lay.hkv, a.batch);
  dkv_kernel<float, D><<<grid_kv, kThreads, smem_kv, a.stream>>>(
      a.lay, Q, K, V, G, a.lse, a.delta, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.mk, tile_q);
  return static_cast<int>(cudaGetLastError());
}

// bf16: the tensor-core passes at (BQ, BKV)
template <int D, int BQ, int BKV>
int launch_mma(const Args& a) {
  const bf16* Q = static_cast<const bf16*>(a.q);
  const bf16* K = static_cast<const bf16*>(a.k);
  const bf16* V = static_cast<const bf16*>(a.v);
  const bf16* G = static_cast<const bf16*>(a.go);
  const size_t smem_q = attn_mma::dq_smem_bytes<D>(BQ, BKV);
  int e = allow_smem(dq_mma_kernel<D, BQ, BKV>, smem_q);
  if (e) return e;
  const dim3 grid_q((a.lay.sq * a.lay.groups + BQ - 1) / BQ, a.lay.hkv,
                    a.batch);
  dq_mma_kernel<D, BQ, BKV><<<grid_q, 2 * BQ, smem_q, a.stream>>>(
      a.lay, Q, K, V, G, static_cast<const bf16*>(a.o), a.lse, a.delta,
      static_cast<bf16*>(a.dq), a.mk);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t smem_kv = attn_mma::dkv_smem_bytes<D>(BQ, BKV);
  e = allow_smem(dkv_mma_kernel<D, BQ, BKV>, smem_kv);
  if (e) return e;
  const dim3 grid_kv((a.lay.skv + BKV - 1) / BKV, a.lay.hkv, a.batch);
  dkv_mma_kernel<D, BQ, BKV><<<grid_kv, 2 * BKV, smem_kv, a.stream>>>(
      a.lay, Q, K, V, G, a.lse, a.delta, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.mk);
  return static_cast<int>(cudaGetLastError());
}

// the (block_q, block_kv) pairs flash_tiles can return
// (flash_attention.MMA_TILES)
template <int D>
int dispatch_mma(const Args& a, int bq, int bkv) {
#define BWD(BQ, BKV) \
  if (bq == BQ && bkv == BKV) return launch_mma<D, BQ, BKV>(a)
  BWD(16, 16); BWD(16, 32); BWD(16, 64);
  BWD(32, 16); BWD(32, 32); BWD(32, 64);
  BWD(64, 16); BWD(64, 32); BWD(64, 64);
#undef BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// (dq, dk, dv) of flash attention.  q, o, go (B, Sq, Hq, D); k, v (B, Skv,
// Hkv, D); lse (B, Hq, Sq) fp32; delta (B, Hq, Sq) fp32 scratch, written
// by the dq pass and read by the dk/dv pass; dq, dk, dv like q, k, v.
// dtype: 0 = float32 (CUDA cores: tile_q query rows per dk/dv step,
// tile_kv keys per dq step), 1 = bfloat16 (tensor cores at (block_q,
// block_kv) = (tile_q, tile_kv)).  Returns a cudaError_t.
extern "C" int flash_attention_bwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v,
                                   const void* go, const void* o,
                                   const void* lse, void* delta, void* dq,
                                   void* dk,
                                   void* dv, int batch, int sq, int skv,
                                   int hq, int hkv, int causal, int window,
                                   float logit_cap, int tile_q, int tile_kv,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv || tile_q < 1 || tile_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0 || skv == 0) return 0;
  if (!attn_mma::FastDiv::exact(int64_t(sq) * (hq / hkv), hq / hkv))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{BwdLayout{sq, skv, hq, hkv, hq / hkv,
                         attn_mma::FastDiv(uint32_t(hq / hkv))},
               batch, q, k, v, go, o,
               static_cast<const float*>(lse),
               static_cast<float*>(delta), dq, dk, dv,
               attn::Mask{causal, window, 1.0f / sqrtf(float(head_dim)),
                          logit_cap, head_dim},
               static_cast<cudaStream_t>(stream)};
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0) return launch_fp32<D>(a, tile_q, tile_kv);
    return dispatch_mma<D>(a, tile_q, tile_kv);
  });
}
