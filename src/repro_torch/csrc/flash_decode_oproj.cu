// Paged single-token decode with the output projection fused in, for
// Hopper: the port of repro/kernels/flash_decode.py::flash_decode_oproj
// (_decode_oproj_kernel :360, pallas_call at :460).
//
// q (B, Hkv, G, D); pools (n_pages, page, Hkv, D); block_tables
// (B, n_blocks) and lengths (B,) int32, as flash_decode.cu with q_span 1;
// wo (Hkv, G*D, E), the dense (Hq*D, E) projection grouped by kv head.
// out (B, E) = sum over heads h of attn[b, h] (1, G*D) @ wo[h]; the
// attention output never reaches HBM.
//
// The TPU kernel walked the heads of one batch row in order and kept a
// (1, E) fp32 accumulator resident across them, with each head's whole
// (G*D, E) wo slab in VMEM (4 MiB at granite in bf16, 8 MiB double
// buffered: 18x what one block's shared memory can hold).  Here:
//  * one thread-block cluster of c blocks per batch row, c the largest
//    divisor of Hkv that is at most 8 (the portable cluster limit): block
//    r takes kv heads r, r + c, r + 2c, ... (one head where Hkv <= 8).
//    For each, in that order, it runs the attention of the head's G rows
//    with the streaming-softmax core of flash_decode (attn_rows.cuh; the
//    KV tile is the page), kWarps rows at a time, and keeps the G x
//    head_dim fp32 result in shared memory;
//  * it streams its heads' wo slabs from global memory (L2) in 16-byte
//    row vectors, never staging them, and sums its (1, E) fp32 partial
//    product in registers, column slice by column slice, over its heads
//    in head order and each head's rows in order, into shared memory;
//  * the cluster then reduces across blocks through distributed shared
//    memory: block r sums, for its E / c output columns, the partials of
//    blocks 0, 1, ..., c - 1 in that order (map_shared_rank) and writes
//    them.  The order is fixed, so the result is the same on every run;
//    no atomics, and nothing but the output goes to HBM.  It differs
//    from a sum in plain head order only by fp32 rounding (at Hkv <= 8,
//    c = Hkv and it is the plain order).
// head_dim: any multiple of 16 up to 256, at the smallest compiled width
// at least it (attn_rows.cuh); the attention rows are kept at head_dim.
//
// Bound on this card: bytes.  Each batch row's cluster reads every head's
// wo slab, B * Hq * D * E elements a call where the unfused GEMM reads
// Hq * D * E once, less what the 50 MB L2 keeps between batch rows -- the
// TPU kernel's own "when fusion loses" trade (flash_decode.py:426-434).
// At granite, B = 8: the slabs are 33.5 MB, read 8 times.
#include <cooperative_groups.h>

#include "attn_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
constexpr int kVecsPerThread = 4;  // 16-byte column vectors per pass

struct RowsToSmem {
  float* a;  // [G][hd] fp32
  int hd;
  __device__ void put(int t, int d, float x) const { a[t * hd + d] = x; }
};

// eight or four consecutive wo elements as floats
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// the attention tiles at the instance's D, the block's heads' G x hd
// rows, the (1, E) partial (kernels/flash_decode.py::
// oproj_smem_bytes_required)
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int page, int D, int hd,
                                                int groups, int heads,
                                                int e_dim) {
  return attn::smem_bytes<T>(page, D) +
         (size_t(heads) * groups * hd + e_dim) * sizeof(float);
}

// the blocks of one batch row's cluster: the largest divisor of hkv that
// is at most kMaxCluster
inline int cluster_size(int hkv) {
  for (int c = kMaxCluster; c > 1; --c)
    if (hkv % c == 0) return c;
  return 1;
}

// kMulti: the block holds Hkv / c > 1 kv heads (else exactly one, and
// the head loops below are one pass the compiler removes).  kExact:
// head_dim is the instance's D, a constant to the compiler (the row
// strides, the wo row count and its unrolled loop, the staging masks).
template <typename T, int D, bool kMulti, bool kExact>
__global__ void __launch_bounds__(attn::kThreads)
decode_oproj_kernel(attn::PagedLayout lay, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ wo, T* __restrict__ out,
                    attn::Mask mk, int e_dim) {
  if constexpr (kExact) mk.hd = D;
  constexpr int V = 16 / sizeof(T);
  constexpr int kSpan = attn::kThreads * kVecsPerThread * V;
  extern __shared__ __align__(16) unsigned char smem[];
  const int groups = lay.gtot, page = lay.page, hd = mk.hd;
  const int rank = blockIdx.x, c = gridDim.x, b = blockIdx.y;
  const int heads = kMulti ? lay.hkv / c : 1;  // kv heads rank, rank + c..
  const int n_rows = groups * hd;                // of one head's wo slab
  float* const a_s = reinterpret_cast<float*>(
      smem + attn::smem_bytes<T>(page, D));      // [heads][G][hd]
  float* const part = a_s + heads * n_rows;       // [E]

  for (int h = 0; h < heads; ++h) {
    const RowsToSmem sink{a_s + h * n_rows, hd};
    for (int t0 = 0; t0 < groups; t0 += attn::kWarps) {
      attn::attn_rows<T, D>(lay, q, k, v, mk, page, b, rank + h * c, t0,
                            smem, sink);
      __syncthreads();  // a_s is complete; the tiles may be reused
    }
  }

  // part[e] = sum over the block's heads in order, and over each head's
  // G*hd rows in order, of a_s[h][i] * wo[rank + h c, i, e]; thread x
  // owns column vectors x, x + kThreads, ... of a slice
  for (int e0 = 0; e0 < e_dim; e0 += kSpan) {
    float acc[kVecsPerThread][V];
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j)
#pragma unroll
      for (int x = 0; x < V; ++x) acc[j][x] = 0.f;
    for (int h = 0; h < heads; ++h) {
      const float* const a_h = a_s + h * n_rows;
      const T* const w = wo + int64_t(rank + h * c) * n_rows * e_dim;
#pragma unroll 2
      for (int i = 0; i < n_rows; ++i) {
        const float ai = a_h[i];
        const T* const wr = w + int64_t(i) * e_dim;
#pragma unroll
        for (int j = 0; j < kVecsPerThread; ++j) {
          const int col = e0 + (j * attn::kThreads + threadIdx.x) * V;
          if (col < e_dim) {
            float f[V];
            load_vec(wr + col, f);
#pragma unroll
            for (int x = 0; x < V; ++x) acc[j][x] = fmaf(ai, f[x], acc[j][x]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kVecsPerThread; ++j) {
      const int col = e0 + (j * attn::kThreads + threadIdx.x) * V;
      if (col < e_dim) {
#pragma unroll
        for (int x = 0; x < V; ++x) part[col + x] = acc[j][x];
      }
    }
  }

  // the cluster's blocks are this batch row's, rank = blockIdx.x
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every block's partial is in its shared memory
  const int per = (e_dim + c - 1) / c;
  const int hi = min(e_dim, (rank + 1) * per);
  for (int e = rank * per + threadIdx.x; e < hi; e += attn::kThreads) {
    float s = 0.f;
    for (int r = 0; r < c; ++r) s += cluster.map_shared_rank(part, r)[e];
    out[int64_t(b) * e_dim + e] = attn::from_f<T>(s);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

template <typename T, int D>
int launch(const attn::PagedLayout& lay, int batch, const void* q,
           const void* k, const void* v, const void* wo, void* out,
           attn::Mask mk, int e_dim, cudaStream_t stream) {
  const int c = cluster_size(lay.hkv), heads = lay.hkv / c;
  const size_t smem =
      smem_bytes<T>(lay.page, D, mk.hd, lay.gtot, heads, e_dim);
  auto kernel = heads > 1       ? decode_oproj_kernel<T, D, true, false>
                : mk.hd == D ? decode_oproj_kernel<T, D, false, true>
                             : decode_oproj_kernel<T, D, false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(c, batch, 1);
  cfg.blockDim = dim3(attn::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, lay, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(wo),
      static_cast<T*>(out), mk, e_dim);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int flash_decode_oproj_fwd(int dtype, int head_dim, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* lengths, const void* wo,
                                      void* out, int batch, int hkv,
                                      int groups, int page, int n_blocks,
                                      int e_dim, int window, float logit_cap,
                                      void* stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || page <= 0 || e_dim <= 0 ||
      e_dim % (16 / (dtype ? 2 : 4)) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{groups, groups, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      head_dim};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return launch<float, D>(lay, batch, q, k_pages, v_pages, wo, out, mk,
                              e_dim, s);
    return launch<__nv_bfloat16, D>(lay, batch, q, k_pages, v_pages, wo, out,
                                    mk, e_dim, s);
  });
}
