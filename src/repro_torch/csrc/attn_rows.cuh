// Streaming-softmax attention over query rows on CUDA cores: the core of
// row 3's attention (flash_decode_oproj.cu), of the fp32 instances of the
// paged decode kernels (flash_decode.cu, flash_decode_fp8.cu; their bf16
// instances run decode_mma.cuh) and of flash_attention.cu's fp32
// instance (its bf16 instance runs on the tensor cores, attn_mma.cuh).
//
// attn_rows() runs kWarps query rows of one (batch, kv head) pair in one
// block and hands each finished row to a sink: attn_rows_kernel writes it
// out (one block per kWarps rows), flash_decode_oproj keeps it in shared
// memory for the output projection.  A block owns kWarps query rows of
// one (batch, kv head) pair, one row per warp, and walks the keys those
// rows can see in tiles of `tile` keys, a runtime argument: the paged
// kernels pass their page size (so the KV tile is one page, as on the TPU,
// and the blocking model's page choice is the kernel's tile),
// flash_attention's fp32 instance the block_kv of flash_tiles.  K and V
// tiles are staged raw, in their own element type TK (the input dtype, or
// fp8 e4m3 bytes for flash_decode_fp8: one 16-byte cp.async carries 16
// keys' dims), in dynamic shared memory two stages deep: the next tile is
// copied with 16-byte cp.async while the current one is scored.  fp8
// elements are widened in registers (e4m3 is exact in fp16, and fp16 in
// fp32); the per-kv-head scales of an fp8 cache fold into the score
// scale (k) and into the finished row (v), so no widened tile is ever
// stored.  Lane j
// scores keys j, j + 32, ... of the tile against its warp's row and parks
// the scores in a per-warp row of shared memory; the running max m,
// denominator l and the fp32 accumulator (lane j holds dims j, j+32, ...)
// carry across tiles in registers -- on the TPU they were VMEM scratch
// carried across the sequential KV grid axis, which Hopper's unordered
// blocks cannot do.  Each lane walks the head dim starting at its own
// offset (kRot * lane; a 32-bit word per lane for fp8), so the 32 lanes of
// a warp, each on a different key row, read 32 different banks of the
// unpadded K tile.
//
// The kernels differ only in where rows and keys live, which a Layout
// supplies (all offsets in units of head_dim-element rows):
//   int rows()                   query rows per (batch, kv head)
//   int64_t q_row(b, hk, t)      row index of query row t (output alike)
//   int qpos(b, t)               absolute position of query row t
//   int kv_len(b)                keys that exist for batch b
//   int64_t k_row(b, hk, kpos)   row index of key kpos (value alike)
//   void row_stats(b, hk, t, m, l)
//                                the finished row's running max and
//                                denominator (flash_attention writes its
//                                lse residual here; the paged layouts
//                                ignore them)
// Rows are position-major inside a (batch, kv head): qpos never decreases
// with t, so the last row of a block bounds what the block can see.
//
// Head dims.  D, the width a kernel is compiled for, is one of 32, 64,
// 128 and 256; a call runs the smallest D at least its true head_dim
// (Mask::hd, a multiple of 16: with_head_dim).  Rows in global memory are
// hd elements apart; shared-memory rows are D wide, the columns in
// [hd, D) of q, K and V staged as zeros (shared memory is not
// initialised, and 0 x NaN = NaN), and only hd columns are stored.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace attn {

constexpr int kWarps = 4;                 // query rows per block
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;         // the JAX kernels' NEG_INF
constexpr float kBig = 1e30f;             // lse of a row that sees nothing

struct Mask {
  int causal;     // key kpos is visible to row qpos only if kpos <= qpos
  int window;     // > 0: and only if kpos > qpos - window
  float scale;    // head_dim ** -0.5
  float cap;      // > 0: scores become cap * tanh(s / cap)
  int hd;         // the true head_dim (<= the instance's D): row stride
  // fp8 cache: per-kv-head fp32 dequantisation scales (Hkv,), or null
  const float* k_scale = nullptr;
  const float* v_scale = nullptr;
};

using fp8 = __nv_fp8_storage_t;   // one e4m3 byte

// Dynamic shared memory of one block (mirrored by smem_bytes_required in
// kernels/flash_decode.py): K and V tiles, two stages each, in TK, the q
// rows in the input dtype T; one fp32 score row per warp.
template <typename T, typename TK = T>
__host__ __device__ constexpr size_t smem_bytes(int tile, int head_dim) {
  return size_t(2) * 2 * tile * head_dim * sizeof(TK) +
         size_t(kWarps) * head_dim * sizeof(T) +
         size_t(kWarps) * tile * sizeof(float);
}

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
__device__ __forceinline__ float to_f(fp8 x) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}
// four consecutive e4m3 bytes (one 32-bit word) as floats
__device__ __forceinline__ void fp8x4_to_f(uint32_t u, float* f) {
  const float2 lo = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(u & 0xffffu), __NV_E4M3)));
  const float2 hi = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(u >> 16), __NV_E4M3)));
  f[0] = lo.x; f[1] = lo.y; f[2] = hi.x; f[3] = hi.y;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// Paged KV (flash_decode, flash_decode_oproj): q (B, Hkv, gtot, D) with
// rows position-major (row t is position offset t / groups); pools
// (n_pages, page, Hkv, D); block_tables (B, n_blocks) int32; lengths (B,)
// int32 counting the cache including the first spanned token.
struct PagedLayout {
  int gtot, groups, hkv, page, n_blocks;
  const int* block_tables;
  const int* lengths;
  __host__ __device__ int rows() const { return gtot; }
  __device__ int64_t q_row(int b, int hk, int t) const {
    return (int64_t(b) * hkv + hk) * gtot + t;
  }
  __device__ int qpos(int b, int t) const {
    return lengths[b] - 1 + t / groups;
  }
  __device__ int kv_len(int) const { return n_blocks * page; }
  __device__ int64_t k_row(int b, int hk, int kpos) const {
    const int64_t phys = block_tables[int64_t(b) * n_blocks + kpos / page];
    return (phys * page + kpos % page) * hkv + hk;
  }
  __device__ void row_stats(int, int, int, float, float) const {}
};

// Pages [first, end) of split sp of n: the pages holding keys [k_lo,
// k_hi) cut into n page-aligned runs of ceil(pages / n), the last ones
// short or empty.  The split decode kernels (flash_decode_oproj.cu,
// decode_mma.cuh) cut their rows' keys by this rule.
struct PageRun {
  int first, end;
};
__host__ __device__ inline PageRun page_run(int k_lo, int k_hi, int page,
                                            int n, int sp) {
  const int p0 = k_lo / page, p1 = (k_hi + page - 1) / page;
  const int per = p1 > p0 ? (p1 - p0 + n - 1) / n : 0;
  const int first = p0 + sp * per < p1 ? p0 + sp * per : p1;
  return {first, first + per < p1 ? first + per : p1};
}

// Score of one staged fp8 key row against the warp's q row: each lane
// walks the row a 32-bit word (4 e4m3 values) at a time, starting at its
// own word, so the 32 lanes (each on its own key row) read 32 banks.
template <int D, typename T>
__device__ __forceinline__ float dot_fp8_row(const T* qs, const fp8* kr,
                                             int lane) {
  constexpr int W = D / 4;
  const uint32_t* kw = reinterpret_cast<const uint32_t*>(kr);
  float sc = 0.f;
#pragma unroll 8
  for (int i = 0; i < W; ++i) {
    const int w = (i + lane) & (W - 1);
    float f[4];
    fp8x4_to_f(kw[w], f);
#pragma unroll
    for (int c = 0; c < 4; ++c) sc = fmaf(to_f(qs[4 * w + c]), f[c], sc);
  }
  return sc;
}

// Rows t0 .. t0 + kWarps - 1 of (batch b, kv head hk), one per warp, in
// the block's dynamic shared memory `smem` (smem_bytes<T, TK>(tile, D)).
// q in T, K and V in TK (T, or fp8 with mk's per-head scales).  Each
// finished row goes to the sink, one value at a time:
//   sink.put(int t, int d, float value)   row t, head dim d, normalised.
template <typename T, int D, class Layout, class Sink, typename TK>
__device__ __forceinline__ void attn_rows(const Layout& lay,
                                          const T* __restrict__ q,
                                          const TK* __restrict__ k,
                                          const TK* __restrict__ v,
                                          const Mask& mk, int tile, int b,
                                          int hk, int t0,
                                          unsigned char* smem,
                                          const Sink& sink) {
  static_assert(D % 32 == 0 && (D & (D - 1)) == 0,
                "the instance's D must be a power of two, at least 32");
  constexpr bool kFp8 = sizeof(TK) == 1;
  constexpr int P = D / 32;                // accumulator dims per lane
  constexpr int VEC = 16 / sizeof(TK);     // elements per 16-byte copy
  constexpr int VPR = D / VEC;             // 16-byte copies per key row
  constexpr int kRot = kFp8 ? 1 : 4 / sizeof(TK);  // head-dim step/lane
  TK* const Ks = reinterpret_cast<TK*>(smem);          // [2][tile][D]
  TK* const Vs = Ks + 2 * tile * D;                    // [2][tile][D]
  T* const Qs = reinterpret_cast<T*>(Vs + 2 * tile * D);  // [kWarps][D]
  float* const Ps =                                    // [kWarps][tile]
      reinterpret_cast<float*>(Qs + kWarps * D);
  // an fp8 cache's per-head scales: k's folds into the score scale, v's
  // into the finished row (unit, and exact, for a wide cache)
  const float s_scale =
      mk.scale * (mk.k_scale != nullptr ? mk.k_scale[hk] : 1.f);
  const float v_scale = mk.v_scale != nullptr ? mk.v_scale[hk] : 1.f;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = lay.rows();
  const int t = t0 + warp;
  const bool row_ok = t < rows;
  const int t_last = min(t0 + kWarps, rows) - 1;

  const int hd = mk.hd;
  T* const qs = Qs + warp * D;
  if (row_ok) {
    const T* qr = q + lay.q_row(b, hk, t) * hd;
    for (int d = lane; d < D; d += 32)
      qs[d] = d < hd ? qr[d] : from_f<T>(0.f);
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

  // stage s <- keys c0 .. c0 + tile; keys at or past k_hi, and columns
  // at or past hd, are zero (their scores are masked, and a zero V row
  // keeps p * V finite)
  auto load_tile = [&](int s, int c0) {
    TK* ks = Ks + s * tile * D;
    TK* vs = Vs + s * tile * D;
    for (int idx = threadIdx.x; idx < tile * VPR; idx += kThreads) {
      const int j = idx / VPR, e = (idx % VPR) * VEC;
      const int kpos = c0 + j;
      if (kpos < k_hi && e < hd) {
        const int64_t off = lay.k_row(b, hk, kpos) * hd + e;
        cp_async16(ks + j * D + e, k + off);
        cp_async16(vs + j * D + e, v + off);
      } else {
        *reinterpret_cast<uint4*>(ks + j * D + e) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vs + j * D + e) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    cp_async_commit();
  };

  const int c_first = (k_lo / tile) * tile;
  if (c_first < k_hi) load_tile(0, c_first);
  float* const ps = Ps + warp * tile;
  int s = 0;
  for (int c0 = c_first; c0 < k_hi; c0 += tile, s ^= 1) {
    if (c0 + tile < k_hi) {
      load_tile(s ^ 1, c0 + tile);   // in flight while this tile is scored
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile s has landed for every thread; Qs is visible
    if (row_ok) {
      const TK* ks = Ks + s * tile * D;
      const TK* vs = Vs + s * tile * D;
      float smax = kNegInf;
      for (int j = lane; j < tile; j += 32) {
        const int kpos = c0 + j;
        const TK* kr = ks + j * D;
        float sc = 0.f;
        if constexpr (kFp8) {
          sc = dot_fp8_row<D>(qs, kr, lane);
        } else {
#pragma unroll 16
          for (int i = 0; i < D; ++i) {
            const int d = (i + kRot * lane) & (D - 1);
            sc = fmaf(to_f(qs[d]), to_f(kr[d]), sc);
          }
        }
        sc *= s_scale;
        if (mk.cap > 0.f) sc = mk.cap * tanhf(sc / mk.cap);
        bool valid = kpos < kv_len;
        if (mk.causal) valid = valid && kpos <= qpos;
        if (mk.window > 0) valid = valid && kpos > qpos - mk.window;
        sc = valid ? sc : kNegInf;
        ps[j] = sc;
        smax = fmaxf(smax, sc);
      }
      // _softmax_update of the TPU kernel, with its NaN guards: a row with
      // nothing visible yet (m <= NEG_INF / 2) keeps alpha = 0 and p = 0.
      const float m_new = fmaxf(m, warp_max(smax));
      const float m_sub = m_new <= kNegInf / 2 ? 0.f : m_new;
      float psum = 0.f;
      for (int j = lane; j < tile; j += 32) {
        const float sc = ps[j];
        const float p = sc <= kNegInf / 2 ? 0.f : expf(sc - m_sub);
        ps[j] = p;
        psum += p;
      }
      const float alpha =
          m <= kNegInf / 2 ? 0.f : expf(fminf(m - m_new, 0.f));
      l = l * alpha + warp_sum(psum);
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] *= alpha;
      __syncwarp();  // every lane's p is in ps
      const int n_keys = min(tile, k_hi - c0);
#pragma unroll 4
      for (int j = 0; j < n_keys; ++j) {
        const float pj = ps[j];
        const TK* vr = vs + j * D;
#pragma unroll
        for (int i = 0; i < P; ++i)
          acc[i] = fmaf(pj, to_f(vr[lane + 32 * i]), acc[i]);
      }
      __syncwarp();  // ps is read before the next tile overwrites it
      m = m_new;
    }
    __syncthreads();  // everyone is done with tile s before it is reused
  }

  if (row_ok) {
    const float safe_l = l == 0.f ? 1.f : l;
#pragma unroll
    for (int i = 0; i < P; ++i)
      if (lane + 32 * i < hd)
        sink.put(t, lane + 32 * i, acc[i] * v_scale / safe_l);
    if (lane == 0) lay.row_stats(b, hk, t, m, l);
  }
}

// The sink of the two attention kernels: row t of (b, hk) into o, in the
// input dtype (rows hd elements apart).
template <typename T, class Layout> struct RowOut {
  const Layout& lay;
  T* o;
  int b, hk, hd;
  __device__ void put(int t, int d, float x) const {
    o[lay.q_row(b, hk, t) * hd + d] = from_f<T>(x);
  }
};

// One block per kWarps rows of one (batch, kv head): grid
// (ceil(rows / kWarps), n_kv_heads, batch).
template <typename T, int D, class Layout, typename TK = T>
__global__ void __launch_bounds__(kThreads)
attn_rows_kernel(Layout lay, const T* __restrict__ q,
                 const TK* __restrict__ k, const TK* __restrict__ v,
                 T* __restrict__ o, Mask mk, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.z, hk = blockIdx.y;
  const RowOut<T, Layout> sink{lay, o, b, hk, mk.hd};
  attn_rows<T, D>(lay, q, k, v, mk, tile, b, hk, blockIdx.x * kWarps, smem,
                  sink);
}

template <typename T, int D, class Layout, typename TK = T>
int launch_rows(const Layout& lay, int n_kv_heads, int batch, const void* q,
                const void* k, const void* v, void* o, Mask mk, int tile,
                cudaStream_t stream) {
  const int rows = lay.rows();
  if (rows == 0 || n_kv_heads == 0 || batch == 0) return 0;
  if (tile < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, TK>(tile, D);
  auto kernel = attn_rows_kernel<T, D, Layout, TK>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((rows + kWarps - 1) / kWarps, n_kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      lay, static_cast<const T*>(q), static_cast<const TK*>(k),
      static_cast<const TK*>(v), static_cast<T*>(o), mk, tile);
  return static_cast<int>(cudaGetLastError());
}

// Run f with the compile-time width of the instance that takes head_dim:
// the smallest of 32, 64, 128 and 256 at least head_dim, a multiple of 16
// (kernels/flash_attention.py::instance_head_dim).  Anything else is
// cudaErrorInvalidValue.
template <class F> int with_head_dim(int head_dim, F&& f) {
  if (head_dim < 16 || head_dim % 16 || head_dim > 256)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim <= 32) return f(std::integral_constant<int, 32>{});
  if (head_dim <= 64) return f(std::integral_constant<int, 64>{});
  if (head_dim <= 128) return f(std::integral_constant<int, 128>{});
  return f(std::integral_constant<int, 256>{});
}

}  // namespace attn
