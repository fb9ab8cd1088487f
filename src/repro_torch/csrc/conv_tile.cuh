// Staging shared by the two direct-convolution kernels: conv2d_blocked.cu
// (the forward, kernel row 12, which the dgrad also runs) and
// conv2d_wgrad.cu (the weight gradient, row 13).
//
// Layouts are the JAX package's: x (N, H, W, C), w (Fh, Fw, C, K), the
// output and the cotangent (N, OH, OW, K), all contiguous.  A block stages
// a haloed input tile of ih x iw pixels and bc channels in shared memory,
// pixel after pixel, each pixel a row of pixel_stride(bc) elements; the
// forward also stages a weight tile (Fh * Fw taps x bc channels x bk
// columns), the wgrad a cotangent tile (by x bx pixels x bk columns).
// Rows are whole 16-byte vectors: a vector whose source lies in range and
// is 16-byte aligned is copied by one cp.async; any other (the ragged
// edge of C, K or the image; C = 3 pixels, 6 bytes apart in bf16) element
// by element, with what lies outside zero-filled.  So every shape stages,
// and the compute loops need no bounds: zeros add nothing.
#pragma once

#include "gemm_tile.cuh"

namespace conv {

constexpr int kThreads = 256;
constexpr int kCols = 4;  // output columns (K) a thread holds

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int round_up(int a, int m) {
  return ceil_div(a, m) * m;
}

// Elements between two staged pixels: bc rounded up to whole 16-byte
// vectors, an odd number of them, so that reads of neighbouring pixels
// (the thread-rows of a warp) fall into different bank groups.
template <typename T> __host__ __device__ inline int pixel_stride(int bc) {
  constexpr int V = 16 / sizeof(T);
  const int chunks = ceil_div(bc, V);
  return (chunks | 1) * V;
}

// 16-byte vectors between two staged rows of bk bf16 columns that the
// tensor cores read with ldmatrix (row 12's weight tile, row 13's
// cotangent tile; conv2d_blocked.weight_vectors).  The 8 rows of one
// ldmatrix sub-matrix must fall into distinct bank groups: a power of two
// (2 or more) is XOR-swizzled for that, unpadded; an odd count needs
// nothing; any other is padded by one vector to odd.
__host__ __device__ inline int row_vectors(int bk) {
  const int v = ceil_div(bk, 8);
  return (v & 1) || (v & (v - 1)) == 0 ? v : v + 1;
}

// the swizzle of a row of v vectors: logical vector L = r * v + c sits at
// L ^ ((L >> shift) & mask), which XORs c with r (v >= 8) or with the
// 128-byte line (v = 2, 4); mask 0 where v is odd (no swizzle)
struct Swizzle {
  int shift, mask;
};
__device__ inline Swizzle row_swizzle(int v) {
  if (v < 2 || (v & (v - 1))) return Swizzle{0, 0};
  return Swizzle{max(3, 31 - __clz(v)), 7};
}

// The first n (<= 0: none) of the V elements at src into the 16-byte
// vector at dst, the rest zero.
template <typename T>
__device__ __forceinline__ void stage_vec(T* dst, const T* src, int n) {
  constexpr int V = 16 / sizeof(T);
  if (n >= V && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    gemm::cp_async16(dst, src);
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) dst[e] = e < n ? src[e] : gemm::zero<T>();
  }
}

// The haloed input tile of image n: rows h0 .. h0 + ih and columns
// w0 .. w0 + iw of x, channels c0 .. c0 + bc, into xs (ih * iw pixels of
// pst elements).  Zero outside the image, past C and past bc.  Only the
// first nv vectors of a pixel are staged (default: all of pst): the
// rest are never read.  A thread keeps one vector column of the pixels
// it stages, so the pixel's row and column cost one division.
template <typename T>
__device__ __forceinline__ void stage_input(T* xs, const T* x, int n, int H,
                                            int W, int C, int h0, int w0,
                                            int ih, int iw, int c0, int bc,
                                            int pst, int nv = 0) {
  constexpr int V = 16 / sizeof(T);
  if (nv <= 0) nv = pst / V;
  const int cols = min(nv, kThreads), step = kThreads / cols;
  if (threadIdx.x >= step * cols) return;
  for (int pix = threadIdx.x / cols; pix < ih * iw; pix += step) {
    const int r = pix / iw, q = pix - r * iw;
    const int h = h0 + r, w = w0 + q;
    const T* const src = x + ((int64_t(n) * H + h) * W + w) * C + c0;
    for (int e = (threadIdx.x % cols) * V; e < nv * V; e += cols * V) {
      const int n_in = h < H && w < W ? min(V, min(bc - e, C - c0 - e)) : 0;
      stage_vec(xs + pix * pst + e, src + e, n_in);
    }
  }
}

// rows x ld elements from a row-major source of rows that are `len`
// long: staged row r, columns e .. e + V come from src_row(r) + e, of
// which n_row(r) - e are in range.  Used for the weight tile (a row per
// (tap, channel)) and the cotangent tile (a row per pixel).
template <typename T, class Row>
__device__ __forceinline__ void stage_rows(T* dst, int rows, int ld,
                                           const Row& row) {
  constexpr int V = 16 / sizeof(T);
  const int nch = ld / V;
  for (int i = threadIdx.x; i < rows * nch; i += kThreads) {
    const int r = i / nch, e = (i - r * nch) * V;
    const T* src;
    const int n = row(r, src);
    stage_vec(dst + r * ld + e, src + e, n - e);
  }
}

// raise a kernel instance's dynamic shared-memory limit once, to the
// largest tile seen (the attribute call is not free on the host)
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, int& smem_set) {
  if (smem <= smem_set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_set = smem;
  return 0;
}

}  // namespace conv
