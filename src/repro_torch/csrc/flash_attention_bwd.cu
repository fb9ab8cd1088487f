// Flash-attention backward for Hopper: the port of
// repro/kernels/flash_attention_bwd.py::flash_attention_bwd (_dq_kernel
// and _dkv_kernel, pallas_calls at :134 and :148).
//
// The recompute backward: the forward saved only o and lse = m + log(l)
// per query row (flash_attention.cu, (B, Hq, Sq) fp32); each pass replays
// the scores it needs, p = exp(s - lse), and with delta = rowsum(do * o)
// (a torch reduction in the wrapper, as JAX computes it outside its
// kernels) forms ds = p * (dp - delta), dp = do . v, times 1 - t^2 under
// a logit cap (s = cap * t, t = tanh(s_pre / cap)).  Layouts as the
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
// Bound on this card: at the training shapes (Sq = Skv = 512, D = 128)
// the work, about 10 * Sq * Skv / 2 * Hq * D flops causal, is over the
// bf16 ridge only with tensor cores; these passes score on CUDA cores in
// fp32 (like the forward), so they are bound by those and by the
// re-reads of the streamed tiles from L2, not by HBM.  (tile_q, tile_kv)
// come from core.hopper_adapter.flash_tiles, checked against
// dq_smem_bytes / dkv_smem_bytes below (mirrored in
// kernels/flash_attention_bwd.py).
#include "attn_rows.cuh"

namespace {

using attn::kThreads;
using attn::kWarps;

struct BwdLayout {
  int sq, skv, hq, hkv, groups;
  __device__ int rows() const { return sq * groups; }
  // row t of the (batch, kv head)'s query stream: position t / groups,
  // head hk * groups + t % groups
  __device__ int64_t q_row(int b, int hk, int t) const {
    return (int64_t(b) * sq + t / groups) * hq + hk * groups + t % groups;
  }
  __device__ int64_t stat_row(int b, int hk, int t) const {
    return (int64_t(b) * hq + hk * groups + t % groups) * sq + t / groups;
  }
  __device__ int qpos(int t) const { return t / groups + (skv - sq); }
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

__device__ __forceinline__ bool visible(const attn::Mask& mk, int kpos,
                                        int qpos) {
  bool ok = true;
  if (mk.causal) ok = ok && kpos <= qpos;
  if (mk.window > 0) ok = ok && kpos > qpos - mk.window;
  return ok;
}

// p and ds of one (query row, key) pair, the row's x . k already taken
struct Grad {
  float p, ds;
};
__device__ __forceinline__ float score(const attn::Mask& mk, float dot,
                                       float* tc) {
  const float s_pre = dot * mk.scale;
  if (mk.cap > 0.f) {
    *tc = tanhf(s_pre / mk.cap);
    return mk.cap * *tc;
  }
  *tc = 0.f;
  return s_pre;
}
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
          const float* __restrict__ lse, const float* __restrict__ delta,
          T* __restrict__ dq, attn::Mask mk, int tile) {
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
  float lse_t = 0.f, delta_t = 0.f;
  int qpos = 0;
  if (row_ok) {
    const int64_t r = lay.q_row(b, hk, t) * D;
    for (int d = lane; d < D; d += 32) {
      qs[d] = q[r + d];
      gs[d] = go[r + d];
    }
    lse_t = lse[lay.stat_row(b, hk, t)];
    delta_t = delta[lay.stat_row(b, hk, t)];
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
      if (c0 + j < k_hi) {
        const int64_t off = lay.k_row(b, hk, c0 + j) * D + e;
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
        if (kpos < lay.skv && visible(mk, kpos, qpos)) {
          float tc;
          const float sc = score(mk, dot_rot<D>(qs, ks + j * D, lane), &tc);
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
    const int64_t r = lay.q_row(b, hk, t) * D;
#pragma unroll
    for (int i = 0; i < P; ++i)
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
  if (key_ok) {
    const int64_t r = lay.k_row(b, hk, key) * D;
    for (int d = lane; d < D; d += 32) {
      kw[d] = k[r + d];
      vw[d] = v[r + d];
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
      if (c0 + r < t_hi) {
        const int64_t off = lay.q_row(b, hk, c0 + r) * D + e;
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
        if (t < t_hi && visible(mk, key, lay.qpos(t))) {
          float tc;
          const float sc = score(mk, dot_rot<D>(kw, qs + r * D, lane), &tc);
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
    const int64_t r = lay.k_row(b, hk, key) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      dk[r + lane + 32 * i] = attn::from_f<T>(acc_k[i] * mk.scale);
      dv[r + lane + 32 * i] = attn::from_f<T>(acc_v[i]);
    }
  }
}

template <typename Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

template <typename T, int D>
int launch(const BwdLayout& lay, int batch, const void* q, const void* k,
           const void* v, const void* go, const float* lse,
           const float* delta, void* dq, void* dk, void* dv,
           const attn::Mask& mk, int tile_q, int tile_kv, cudaStream_t s) {
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* G = static_cast<const T*>(go);
  const size_t smem_q = dq_smem_bytes<T>(tile_kv, D);
  int e = allow_smem(dq_kernel<T, D>, smem_q);
  if (e) return e;
  const dim3 grid_q((lay.sq * lay.groups + kWarps - 1) / kWarps, lay.hkv,
                    batch);
  dq_kernel<T, D><<<grid_q, kThreads, smem_q, s>>>(
      lay, Q, K, V, G, lse, delta, static_cast<T*>(dq), mk, tile_kv);
  e = static_cast<int>(cudaGetLastError());
  if (e) return e;
  const size_t smem_kv = dkv_smem_bytes<T>(tile_q, D);
  e = allow_smem(dkv_kernel<T, D>, smem_kv);
  if (e) return e;
  const dim3 grid_kv((lay.skv + kWarps - 1) / kWarps, lay.hkv, batch);
  dkv_kernel<T, D><<<grid_kv, kThreads, smem_kv, s>>>(
      lay, Q, K, V, G, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      mk, tile_q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (dq, dk, dv) of flash attention.  q, o, go (B, Sq, Hq, D); k, v (B, Skv,
// Hkv, D); lse and delta (B, Hq, Sq) fp32; dq, dk, dv like q, k, v.
// tile_q: query rows per dk/dv step; tile_kv: keys per dq step.  dtype: 0
// = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_attention_bwd(int dtype, int head_dim, const void* q,
                                   const void* k, const void* v,
                                   const void* go, const void* lse,
                                   const void* delta, void* dq, void* dk,
                                   void* dv, int batch, int sq, int skv,
                                   int hq, int hkv, int causal, int window,
                                   float logit_cap, int tile_q, int tile_kv,
                                   void* stream) {
  if (hkv <= 0 || hq % hkv || tile_q < 1 || tile_kv < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || sq == 0 || skv == 0) return 0;
  const BwdLayout lay{sq, skv, hq, hkv, hq / hkv};
  const attn::Mask mk{causal, window, 1.0f / sqrtf(float(head_dim)),
                      logit_cap};
  const float* L = static_cast<const float*>(lse);
  const float* Dl = static_cast<const float*>(delta);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BWD(T, D)                                                        \
  return launch<T, D>(lay, batch, q, k, v, go, L, Dl, dq, dk, dv, mk,    \
                      tile_q, tile_kv, s)
  if (dtype == 0 && head_dim == 64) BWD(float, 64);
  if (dtype == 0 && head_dim == 128) BWD(float, 128);
  if (dtype == 1 && head_dim == 64) BWD(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) BWD(__nv_bfloat16, 128);
#undef BWD
  return static_cast<int>(cudaErrorInvalidValue);
}
