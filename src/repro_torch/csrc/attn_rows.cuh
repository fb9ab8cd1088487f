// Streaming-softmax attention over query rows: the core shared by the
// port's two attention kernels (flash_attention.cu, flash_decode.cu).
//
// A block owns kWarps query rows of one (batch, kv head) pair, one row per
// warp, and walks the keys those rows can see in tiles of kKeys = 32 keys
// staged in shared memory as fp32.  Each thread loads its share of a tile
// as 16-byte vectors, all issued before any is used, and the next tile's
// loads are in flight while the current tile is scored.  In a tile, lane j
// scores key j against its warp's row (the K tile is padded by one float
// per row, so the 32 lanes read 32 different banks); the running max m,
// denominator l and the fp32 accumulator (lane j holds dims j, j+32, ...)
// carry across tiles in registers -- on the TPU they were VMEM scratch
// carried across the sequential KV grid axis, which Hopper's unordered
// blocks cannot do.
//
// The two kernels differ only in where rows and keys live, which a Layout
// supplies (all offsets in units of head_dim-element rows):
//   int rows()                   query rows per (batch, kv head)
//   int64_t q_row(b, hk, t)      row index of query row t (output alike)
//   int qpos(b, t)               absolute position of query row t
//   int kv_len(b)                keys that exist for batch b
//   int64_t k_row(b, hk, kpos)   row index of key kpos (value alike)
// Rows are position-major inside a (batch, kv head): qpos never decreases
// with t, so the last row of a tile bounds what the tile can see.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 4;                 // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = 32;                 // keys per shared-memory tile
constexpr float kNegInf = -1e30f;         // the JAX kernels' NEG_INF

struct Mask {
  int causal;     // key kpos is visible to row qpos only if kpos <= qpos
  int window;     // > 0: and only if kpos > qpos - window
  float scale;    // head_dim ** -0.5
  float cap;      // > 0: scores become cap * tanh(s / cap)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T -> 16 / sizeof(T) floats (the pointer only picks T)
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const float*) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f,
                                       const __nv_bfloat16*) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 is the top half of an fp32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D, class Layout>
__global__ void __launch_bounds__(kThreads)
attn_rows_kernel(Layout lay, const T* __restrict__ q,
                 const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, Mask mk) {
  static_assert(D % 32 == 0, "head_dim must be a multiple of 32");
  constexpr int P = D / 32;                // accumulator dims per lane
  constexpr int VEC = 16 / sizeof(T);      // elements per 16-byte load
  constexpr int VPR = D / VEC;             // 16-byte vectors per key row
  constexpr int NV = kKeys * VPR / kThreads;  // per thread, per tile
  static_assert(kKeys * VPR % kThreads == 0, "tile must split evenly");
  __shared__ float Ks[kKeys][D + 1];
  __shared__ float Vs[kKeys][D];
  __shared__ float Qs[kWarps][D];

  const int b = blockIdx.z, hk = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = lay.rows();
  const int t0 = blockIdx.x * kWarps;
  const int t = t0 + warp;
  const bool row_ok = t < rows;
  const int t_last = min(t0 + kWarps, rows) - 1;

  if (row_ok) {
    const T* qr = q + lay.q_row(b, hk, t) * D;
    for (int d = lane; d < D; d += 32) Qs[warp][d] = to_f(qr[d]);
  }
  const int qpos = row_ok ? lay.qpos(b, t) : 0;

  // The keys some row of this block can see.  The TPU kernel walks every
  // KV block and masks; stopping early changes no result, because a fully
  // masked tile leaves m, l and acc as they were.
  const int kv_len = lay.kv_len(b);
  int k_hi = kv_len;
  if (mk.causal) k_hi = min(k_hi, lay.qpos(b, t_last) + 1);
  const int k_lo = mk.window > 0 ? max(0, lay.qpos(b, t0) - mk.window + 1)
                                 : 0;

  float m = kNegInf, l = 0.f, acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;

  // the tile's K/V as raw 16-byte vectors; keys at or past k_hi are zero
  uint4 kreg[NV], vreg[NV];
  auto load_tile = [&](int c0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int kpos = c0 + idx / VPR;
      kreg[i] = vreg[i] = make_uint4(0u, 0u, 0u, 0u);
      if (kpos < k_hi) {
        const int64_t off = lay.k_row(b, hk, kpos) * D + (idx % VPR) * VEC;
        kreg[i] = *reinterpret_cast<const uint4*>(k + off);
        vreg[i] = *reinterpret_cast<const uint4*>(v + off);
      }
    }
  };

  const int c_first = (k_lo / kKeys) * kKeys;
  if (c_first < k_hi) load_tile(c_first);
  for (int c0 = c_first; c0 < k_hi; c0 += kKeys) {
    __syncthreads();  // the previous tile is consumed; Qs is visible
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int j = idx / VPR, d0 = (idx % VPR) * VEC;
      float kf[VEC], vf[VEC];
      unpack(kreg[i], kf, k);
      unpack(vreg[i], vf, v);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        Ks[j][d0 + e] = kf[e];
        Vs[j][d0 + e] = vf[e];
      }
    }
    __syncthreads();
    if (c0 + kKeys < k_hi) load_tile(c0 + kKeys);  // overlaps the scoring
    if (!row_ok) continue;

    const int kpos = c0 + lane;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) s = fmaf(Qs[warp][d], Ks[lane][d], s);
    s *= mk.scale;
    if (mk.cap > 0.f) s = mk.cap * tanhf(s / mk.cap);
    bool valid = kpos < kv_len;
    if (mk.causal) valid = valid && kpos <= qpos;
    if (mk.window > 0) valid = valid && kpos > qpos - mk.window;
    s = valid ? s : kNegInf;

    // _softmax_update of the TPU kernel, with its NaN guards: a row with
    // nothing visible yet (m <= NEG_INF / 2) keeps alpha = 0 and p = 0.
    const float m_new = fmaxf(m, warp_max(s));
    const float p =
        valid ? expf(s - (m_new <= kNegInf / 2 ? 0.f : m_new)) : 0.f;
    const float alpha =
        m <= kNegInf / 2 ? 0.f : expf(fminf(m - m_new, 0.f));
    l = l * alpha + warp_sum(p);
#pragma unroll
    for (int i = 0; i < P; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int j = 0; j < kKeys; ++j) {
      const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
      for (int i = 0; i < P; ++i)
        acc[i] = fmaf(pj, Vs[j][lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float safe_l = l == 0.f ? 1.f : l;
    T* orow = o + lay.q_row(b, hk, t) * D;
#pragma unroll
    for (int i = 0; i < P; ++i) orow[lane + 32 * i] = from_f<T>(acc[i] / safe_l);
  }
}

template <typename T, int D, class Layout>
int launch_rows(const Layout& lay, int n_kv_heads, int batch, const void* q,
                const void* k, const void* v, void* o, Mask mk,
                cudaStream_t stream) {
  const int rows = lay.rows();
  if (rows == 0 || n_kv_heads == 0 || batch == 0) return 0;
  const dim3 grid((rows + kWarps - 1) / kWarps, n_kv_heads, batch);
  attn_rows_kernel<T, D, Layout><<<grid, kThreads, 0, stream>>>(
      lay, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), mk);
  return static_cast<int>(cudaGetLastError());
}

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
template <class Layout>
int dispatch(int dtype, int head_dim, const Layout& lay, int n_kv_heads,
             int batch, const void* q, const void* k, const void* v, void* o,
             Mask mk, cudaStream_t stream) {
  if (dtype == 0 && head_dim == 64)
    return launch_rows<float, 64>(lay, n_kv_heads, batch, q, k, v, o, mk,
                                  stream);
  if (dtype == 0 && head_dim == 128)
    return launch_rows<float, 128>(lay, n_kv_heads, batch, q, k, v, o, mk,
                                   stream);
  if (dtype == 1 && head_dim == 64)
    return launch_rows<__nv_bfloat16, 64>(lay, n_kv_heads, batch, q, k, v,
                                          o, mk, stream);
  if (dtype == 1 && head_dim == 128)
    return launch_rows<__nv_bfloat16, 128>(lay, n_kv_heads, batch, q, k, v,
                                           o, mk, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace attn
