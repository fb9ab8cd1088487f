// Blocked GEMM tile core on the CUDA cores: matmul_blocked.cu (no
// epilogue), qkv_fused.cu (one A tile feeding three weight matrices),
// matmul_w8.cu (int8 weights, the per-column scale in the epilogue) and
// matmul_fused.cu's fp32 instance (bias, activation, mul and residual
// applied to the output tile; wide or int8 weights).  matmul_fused's
// bf16 instances run gemm_mma.cuh's tensor-core fragment core.
//
// Block (i, j) owns a (bm, bn) output tile at rows i*bm and walks the
// whole K extent in steps of bk, so its fp32 accumulator is held across
// the reduction -- the paper's output-buffer rule (on the TPU a VMEM
// scratch carried across the sequential k grid axis; here registers,
// since Hopper's blocks run in no order).  The tiles are runtime
// arguments.  Each step stages one A tile (bm, bk) and one B tile
// (bk, bn) in dynamic shared memory, two stages deep: the next step's
// tiles are copied with cp.async while the current ones are used.  A and
// B have their own element types (TA: fp32 or bf16; TB: TA, or int8 for
// the quantized kernels): each tile is staged at its own width, so an
// int8 B tile moves one byte per element, and B is widened to fp32 only
// at the multiply-add.  The
// 256 threads tile the output as thread-rows x column groups of 4:
// ncg = ceil(bn / 4) column groups, n_tr = 256 / ncg thread-rows, and
// each thread holds rows tr, tr + n_tr, ... (at most kMaxRows) x 4
// columns of the accumulator in registers, the row count a template
// argument.  The Python wrappers and the Hopper adapter refuse tiles
// that would need more (accumulators_per_thread in
// kernels/matmul_blocked.py).  Ragged M, N and K edges are masked here:
// out-of-range elements load as zero and are never stored.
//
// Where the columns of a block's tile come from and go to is a Map, a
// small struct passed by value to the kernel:
//   ColRef<T> b_col(int c)   B column of tile column c: pointer to its
//                            row 0 and the row stride (p == nullptr: the
//                            column is past the edge and loads as zero);
//   void store(int m, int c, float acc)
//                            write output row m, tile column c from the
//                            fp32 sum (the epilogue; masks the edge).
// Both read blockIdx.x for the block's column offset.  With 16-byte
// staging, a map guarantees that the V = 16 / sizeof(TB) consecutive
// columns starting at a multiple of V (8 in bf16, 4 in fp32, 16 in int8)
// share one source and are all in range or all out.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gemm {

constexpr int kThreads = 256;
constexpr int kCols = 4;      // output columns per thread
constexpr int kMaxRows = 16;  // output rows per thread: 64 fp32 accumulators

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T> __device__ __forceinline__ T zero() {
  return from_f<T>(0.f);
}
template <> __device__ __forceinline__ int8_t zero<int8_t>() { return 0; }

template <typename T> struct ColRef {
  const T* p;  // B[0, column], or nullptr past the edge
  int ld;      // row stride of that B matrix, in elements
};

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

// four consecutive smem elements of B as floats (16 or 8 bytes, aligned
// because bn and the column are multiples of 4)
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  f[0] = __uint_as_float(u.x << 16);  // bf16 is the top half of an fp32
  f[1] = __uint_as_float(u.x & 0xffff0000u);
  f[2] = __uint_as_float(u.y << 16);
  f[3] = __uint_as_float(u.y & 0xffff0000u);
}
// Four int8 values widened exactly without the int-to-float unit (a
// quarter-rate instruction, which every thread-row of a tile repeats for
// the same B values): byte b + 128 becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is subtracted.
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// Stage the A tile (rows m0.., columns k0..) and the B tile (rows k0..,
// the map's columns) into As (bm, bk) and Bs (bk, bn).  kVec: 16-byte
// cp.async copies (every row start and tile width is a multiple of 16
// bytes: VA = 16 / sizeof(TA) elements of A per copy, VB = 16 / sizeof(TB)
// of B); otherwise one element at a time, synchronously.
template <typename TA, typename TB, bool kVec, class Map>
__device__ __forceinline__ void load_tiles(TA* As, TB* Bs, const TA* A,
                                           const Map& map, int M, int K,
                                           int m0, int k0, int bm, int bk,
                                           int bn) {
  if (kVec) {
    constexpr int VA = 16 / sizeof(TA), VB = 16 / sizeof(TB);
    const int a_vpr = bk / VA, b_vpr = bn / VB;
    for (int i = threadIdx.x; i < bm * a_vpr; i += kThreads) {
      const int r = i / a_vpr, c = (i % a_vpr) * VA;
      TA* dst = As + r * bk + c;
      if (m0 + r < M && k0 + c < K)
        cp_async16(dst, A + int64_t(m0 + r) * K + k0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < bk * b_vpr; i += kThreads) {
      const int r = i / b_vpr, c = (i % b_vpr) * VB;
      TB* dst = Bs + r * bn + c;
      const ColRef<TB> src = map.b_col(c);
      if (k0 + r < K && src.p != nullptr)
        cp_async16(dst, src.p + int64_t(k0 + r) * src.ld);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < bm * bk; i += kThreads) {
      const int r = i / bk, c = i % bk;
      As[i] = (m0 + r < M && k0 + c < K) ? A[int64_t(m0 + r) * K + k0 + c]
                                         : zero<TA>();
    }
    for (int i = threadIdx.x; i < bk * bn; i += kThreads) {
      const int r = i / bn, c = i % bn;
      const ColRef<TB> src = map.b_col(c);
      Bs[i] = (k0 + r < K && src.p != nullptr)
                  ? src.p[int64_t(k0 + r) * src.ld]
                  : zero<TB>();
    }
  }
  cp_async_commit();
}

// R: output rows a thread holds, rounded up to a power of two at launch so
// the row loop is unrolled with no dead iterations (a decode tile of 8 rows
// runs R = 1, a 128 x 128 tile R = 16).  Two resident blocks per SM: the
// shared-memory budget the Hopper adapter sizes tiles under
// (core/hopper_adapter.py) assumes as much.
template <typename TA, typename TB, bool kVec, int R, class Map>
__global__ void __launch_bounds__(kThreads, 2)
gemm_kernel(const TA* __restrict__ A, Map map, int M, int K, int bm, int bk,
            int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  // bytes of an A tile and of one stage (A tile, then B tile); with
  // 16-byte staging both are multiples of 16, so every tile is aligned
  const int a_tile = bm * bk * int(sizeof(TA));
  const int stage = a_tile + bk * bn * int(sizeof(TB));
  unsigned char* const base = smem;
  auto a_at = [=](int s) { return reinterpret_cast<TA*>(base + s * stage); };
  auto b_at = [=](int s) {
    return reinterpret_cast<TB*>(base + s * stage + a_tile);
  };

  const int m0 = blockIdx.y * bm;
  const int ncg = (bn + kCols - 1) / kCols;
  const int n_tr = kThreads / ncg;
  const int cg = threadIdx.x % ncg, tr = threadIdx.x / ncg;
  const bool active = tr < n_tr;
  const int rows = (bm + n_tr - 1) / n_tr;  // <= R (host-checked)
  const int c0 = cg * kCols;

  // smem offset of each of the thread's rows in an A tile.  A row past
  // the tile reads row 0 instead and its sums are never stored: the row
  // loop then has no branch, so the compiler issues all R loads ahead of
  // the multiplies (a guarded loop serialised each row's load latency).
  int arow[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = tr + j * n_tr;
    arow[j] = j < rows && r < bm ? r * bk : 0;
  }
  float acc[R][kCols];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

  const int nk = (K + bk - 1) / bk;
  if (nk > 0)
    load_tiles<TA, TB, kVec>(a_at(0), b_at(0), A, map, M, K, m0, 0, bm, bk,
                             bn);
  for (int t = 0; t < nk; ++t) {
    const TA* As = a_at(t & 1);
    const TB* Bs = b_at(t & 1);
    if (t + 1 < nk) {
      load_tiles<TA, TB, kVec>(a_at((t + 1) & 1), b_at((t + 1) & 1), A, map,
                               M, K, m0, (t + 1) * bk, bm, bk, bn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's tiles have landed for every thread
    if (active) {
      const int kt = min(bk, K - t * bk);  // the ragged last step
      for (int kk = 0; kk < kt; ++kk) {
        float bv[kCols];
        if (kVec) {
          load4(Bs + kk * bn + c0, bv);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            bv[c] = c0 + c < bn ? to_f(Bs[kk * bn + c0 + c]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const float a = to_f(As[arow[j] + kk]);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[j][c] = fmaf(a, bv[c], acc[j][c]);
        }
      }
    }
    __syncthreads();  // everyone is done with this stage before reuse
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int r = tr + j * n_tr;
    if (j < rows && r < bm && m0 + r < M) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c0 + c < bn) map.store(m0 + r, c0 + c, acc[j][c]);
    }
  }
}

template <typename TA, typename TB, bool kVec, int R, class Map>
int launch(const TA* a, const Map& map, int M, int K, int bm, int bk, int bn,
           int col_blocks, cudaStream_t stream) {
  const int smem =
      2 * (bm * bk * int(sizeof(TA)) + bk * bn * int(sizeof(TB)));
  auto kernel = gemm_kernel<TA, TB, kVec, R, Map>;
  // raise this instantiation's dynamic shared-memory limit once, to the
  // largest tile seen (the attribute call is not free on the host)
  static int smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = smem;
  }
  const dim3 grid(col_blocks, (M + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, stream>>>(a, map, M, K, bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

// Launch the tile core over a grid of col_blocks x ceil(M / bm) blocks,
// each with a (bm, bn) output tile; A in TA, the map's B columns in TB.
// vec: the caller's check that A and every B source are 16-byte aligned,
// K and bk are multiples of 16 bytes of TA, and bn and the B widths are
// multiples of 16 bytes of TB.  Returns a cudaError_t.
template <typename TA, typename TB, class Map>
int run(bool vec, const void* a, const Map& map, int M, int K, int bm,
        int bk, int bn, int col_blocks, cudaStream_t s) {
  if (M <= 0 || K < 0 || bm <= 0 || bk <= 0 || bn <= 0 || col_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ncg = (bn + kCols - 1) / kCols;
  if (ncg > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (bm + kThreads / ncg - 1) / (kThreads / ncg);
  if (rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const TA* A = static_cast<const TA*>(a);
#define GEMM_ROWS(V)                                                       \
  if (rows <= 1) return launch<TA, TB, V, 1>(A, map, M, K, bm, bk, bn,     \
                                             col_blocks, s);               \
  if (rows <= 2) return launch<TA, TB, V, 2>(A, map, M, K, bm, bk, bn,     \
                                             col_blocks, s);               \
  if (rows <= 4) return launch<TA, TB, V, 4>(A, map, M, K, bm, bk, bn,     \
                                             col_blocks, s);               \
  if (rows <= 8) return launch<TA, TB, V, 8>(A, map, M, K, bm, bk, bn,     \
                                             col_blocks, s);               \
  return launch<TA, TB, V, kMaxRows>(A, map, M, K, bm, bk, bn, col_blocks, \
                                     s);
  if (vec) {
    GEMM_ROWS(true)
  } else {
    GEMM_ROWS(false)
  }
#undef GEMM_ROWS
}

// 16-byte alignment of a device pointer
inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace gemm
