// Backward (dgrad) GEMMs of the blocked GEMM for Hopper: the port of
// repro/kernels/matmul_bwd.py::matmul_dgrad_a (pallas_call at :66) and
// ::matmul_dgrad_b (:104).
//
// For C[M, N] = A[M, K] @ B[K, N] the two cotangents are GEMMs over the
// same data with one operand read transposed:
//   dA[M, K] = g[M, N] @ B[K, N]^T   (NT: both operands contiguous along
//                                     the reduction, N)
//   dB[K, N] = A[M, K]^T @ g[M, N]   (TN: both operands contiguous along
//                                     the output's rows and columns; the
//                                     reduction, M, is their row index)
// The transpose is done on the tile, never in HBM.  A block owns one
// (bm, bn) output tile and walks the whole reduction in steps of bk with
// its fp32 accumulator in registers -- the paper's output-buffer rule, the
// same as the forward tile core (gemm_tile.cuh, which is left as it is):
// for dB the reduction runs over all of M = B * S inside one block, in a
// fixed order, with no atomics and no split reduction, so repeated
// launches agree bit for bit.  Tiles (bm, bk, bn) are runtime arguments in
// the "matmul_dgrad" key's (M_out, K_reduce, N_out) roles; ragged edges
// are masked, so every shape launches (the JAX op falls back to jnp.dot
// on ragged tiles).  256 threads, each holding up to 16 rows x 4 columns
// of the accumulator, two stages of tiles in dynamic shared memory with
// the next step's copied by cp.async while the current one is used.
//
// * NT (dgrad A) stages both tiles as they lie: bm rows of g and bn rows
//   of B, each bk reduction elements long, the 16-byte chunks of a row
//   XOR-swizzled by the row index so that the compute loop's reads of 4
//   consecutive reduction elements of 8 different rows hit 8 different
//   bank groups.  A thread holds the strided columns cg, cg + ncg, ...
//   (the rows of B a quarter warp reads are then 8 consecutive ones).
// * TN (dgrad B) stages bk rows of A (bm wide) and bk rows of g (bn
//   wide): both along their contiguous axis, which is the output tile's
//   row and column axis, so the compute loop is the forward's with A's
//   tile read down a column (consecutive thread-rows read consecutive
//   words).
//
// Bound on this card: at the training shapes (M = 2048 tokens, granite's
// projections) both are flops bound (2 M N K operations over a few tens
// of MB).  This first kernel multiplies on CUDA cores in fp32, like the
// forward, so it stays far from the 989 TFLOP/s bf16 peak; tensor cores
// are later work.
#include "gemm_tile.cuh"

namespace {

using gemm::kCols;
using gemm::kMaxRows;
using gemm::kThreads;

// the reduction step as staged by NT: rounded up to 8 elements, so a row
// is a whole number of 16-byte chunks in fp32 and bf16
__host__ __device__ inline int round8(int x) { return (x + 7) & ~7; }

// ----------------------------------------------------------------- NT --

// where element e of staged row r lives: chunk e / V XOR-swizzled by the
// row (mask < the lowest set bit of the chunk count, so it stays in row)
template <typename T> struct Swz {
  static constexpr int V = 16 / sizeof(T);
  int ld, mask;
  __device__ __host__ Swz(int bkp) : ld(bkp) {
    const int w = bkp / V;
    const int low = w & -w;
    mask = (low < 8 ? low : 8) - 1;
  }
  __device__ int at(int r, int e) const {
    return r * ld + (((e / V) ^ (r & mask)) * V) + e % V;
  }
};

// Stage rows r0 .. r0 + nr of X (n_rows x len, row-major) at columns
// k0 .. k0 + bk into Xs (nr x bkp, swizzled); out-of-range elements and
// the columns bk .. bkp are zero.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_rows(T* Xs, const T* X, int n_rows,
                                           int len, int r0, int nr, int k0,
                                           int bk, const Swz<T>& sw) {
  constexpr int V = Swz<T>::V;
  const int bkp = sw.ld;
  if (kVec) {
    const int w = bkp / V;
    for (int i = threadIdx.x; i < nr * w; i += kThreads) {
      const int r = i / w, e = (i % w) * V;
      T* dst = Xs + sw.at(r, e);
      if (r0 + r < n_rows && e < bk && k0 + e < len)
        gemm::cp_async16(dst, X + int64_t(r0 + r) * len + k0 + e);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < nr * bkp; i += kThreads) {
      const int r = i / bkp, e = i % bkp;
      Xs[sw.at(r, e)] = (r0 + r < n_rows && e < bk && k0 + e < len)
                            ? X[int64_t(r0 + r) * len + k0 + e]
                            : gemm::zero<T>();
    }
  }
}

// out[M, Nc] = G[M, R] @ B[Nc, R]^T; block (x, y) owns columns x * bn and
// rows y * bm.
template <typename T, bool kVec, int RR>
__global__ void __launch_bounds__(kThreads, 2)
nt_kernel(const T* __restrict__ G, const T* __restrict__ B,
          T* __restrict__ out, int M, int Nc, int R, int bm, int bk,
          int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = round8(bk);
  const Swz<T> sw(bkp);
  const int stage = (bm + bn) * bkp;  // elements of one stage
  T* const base = reinterpret_cast<T*>(smem);
  auto g_at = [=](int s) { return base + s * stage; };
  auto b_at = [=](int s) { return base + s * stage + bm * bkp; };

  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int ncg = (bn + kCols - 1) / kCols;
  const int n_tr = kThreads / ncg;
  const int cg = threadIdx.x % ncg, tr = threadIdx.x / ncg;
  const bool active = tr < n_tr;
  const int rows = (bm + n_tr - 1) / n_tr;

  int arow[RR];  // a row past the tile reads row 0 (never stored)
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    arow[j] = j < rows && r < bm ? r : 0;
  }
  int bcol[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = cg + c * ncg;
    bcol[c] = col < bn ? col : 0;
  }
  float acc[RR][kCols];
#pragma unroll
  for (int j = 0; j < RR; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

  auto load = [&](int s, int k0) {
    stage_rows<T, kVec>(g_at(s), G, M, R, m0, bm, k0, bk, sw);
    stage_rows<T, kVec>(b_at(s), B, Nc, R, n0, bn, k0, bk, sw);
    gemm::cp_async_commit();
  };
  const int nk = (R + bk - 1) / bk;
  if (nk > 0) load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) & 1, (t + 1) * bk);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* Gs = g_at(t & 1);
      const T* Bs = b_at(t & 1);
      // zero-filled past bk and past R on both operands: no ragged bound
      for (int e = 0; e < bkp; e += 4) {
        float bv[kCols][4];
#pragma unroll
        for (int c = 0; c < kCols; ++c) gemm::load4(Bs + sw.at(bcol[c], e),
                                                    bv[c]);
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          float av[4];
          gemm::load4(Gs + sw.at(arow[j], e), av);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[j][c] = fmaf(av[q], bv[c][q], acc[j][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    if (j < rows && r < bm && m0 + r < M) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = cg + c * ncg;
        if (col < bn && n0 + col < Nc)
          out[int64_t(m0 + r) * Nc + n0 + col] = gemm::from_f<T>(acc[j][c]);
      }
    }
  }
}

// ----------------------------------------------------------------- TN --

// Stage rows k0 .. k0 + bk of X (n_red x len, row-major) at columns
// c0 .. c0 + w into Xs (bk x w); out-of-range elements are zero.
template <typename T, bool kVec>
__device__ __forceinline__ void stage_cols(T* Xs, const T* X, int n_red,
                                           int len, int k0, int bk, int c0,
                                           int w) {
  if (kVec) {
    constexpr int V = 16 / sizeof(T);
    const int vpr = w / V;
    for (int i = threadIdx.x; i < bk * vpr; i += kThreads) {
      const int r = i / vpr, c = (i % vpr) * V;
      T* dst = Xs + r * w + c;
      if (k0 + r < n_red && c0 + c < len)
        gemm::cp_async16(dst, X + int64_t(k0 + r) * len + c0 + c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    for (int i = threadIdx.x; i < bk * w; i += kThreads) {
      const int r = i / w, c = i % w;
      Xs[i] = (k0 + r < n_red && c0 + c < len)
                  ? X[int64_t(k0 + r) * len + c0 + c]
                  : gemm::zero<T>();
    }
  }
}

// out[Mo, N] = A[R, Mo]^T @ G[R, N]; block (x, y) owns columns x * bn and
// rows y * bm.
template <typename T, bool kVec, int RR>
__global__ void __launch_bounds__(kThreads, 2)
tn_kernel(const T* __restrict__ A, const T* __restrict__ G,
          T* __restrict__ out, int Mo, int N, int R, int bm, int bk,
          int bn) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stage = bk * (bm + bn);
  T* const base = reinterpret_cast<T*>(smem);
  auto a_at = [=](int s) { return base + s * stage; };
  auto g_at = [=](int s) { return base + s * stage + bk * bm; };

  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int ncg = (bn + kCols - 1) / kCols;
  const int n_tr = kThreads / ncg;
  const int cg = threadIdx.x % ncg, tr = threadIdx.x / ncg;
  const bool active = tr < n_tr;
  const int rows = (bm + n_tr - 1) / n_tr;
  const int c0 = cg * kCols;

  int arow[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    arow[j] = j < rows && r < bm ? r : 0;
  }
  float acc[RR][kCols];
#pragma unroll
  for (int j = 0; j < RR; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

  auto load = [&](int s, int k0) {
    stage_cols<T, kVec>(a_at(s), A, R, Mo, k0, bk, m0, bm);
    stage_cols<T, kVec>(g_at(s), G, R, N, k0, bk, n0, bn);
    gemm::cp_async_commit();
  };
  const int nk = (R + bk - 1) / bk;
  if (nk > 0) load(0, 0);
  for (int t = 0; t < nk; ++t) {
    if (t + 1 < nk) {
      load((t + 1) & 1, (t + 1) * bk);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* As = a_at(t & 1);
      const T* Gs = g_at(t & 1);
      const int kt = min(bk, R - t * bk);
      for (int kk = 0; kk < kt; ++kk) {
        float bv[kCols];
        if (kVec) {
          gemm::load4(Gs + kk * bn + c0, bv);
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            bv[c] = c0 + c < bn ? gemm::to_f(Gs[kk * bn + c0 + c]) : 0.f;
        }
#pragma unroll
        for (int j = 0; j < RR; ++j) {
          const float a = gemm::to_f(As[kk * bm + arow[j]]);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[j][c] = fmaf(a, bv[c], acc[j][c]);
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    if (j < rows && r < bm && m0 + r < Mo) {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (c0 + c < bn && n0 + c0 + c < N)
          out[int64_t(m0 + r) * N + n0 + c0 + c] =
              gemm::from_f<T>(acc[j][c]);
    }
  }
}

// ------------------------------------------------------------- launch --

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

// rows a thread holds for a (bm, bn) tile, or -1 past the kernel's limit
inline int thread_rows(int bm, int bn) {
  const int ncg = (bn + kCols - 1) / kCols;
  if (ncg > kThreads) return -1;
  const int n_tr = kThreads / ncg;
  const int rows = (bm + n_tr - 1) / n_tr;
  return rows > kMaxRows ? -1 : rows;
}

template <typename T, bool kVec, int RR>
int run_nt(const T* g, const T* b, T* out, int M, int Nc, int R, int bm,
           int bk, int bn, cudaStream_t s) {
  static int smem_set = 48 * 1024;
  const int smem = 2 * (bm + bn) * round8(bk) * int(sizeof(T));
  auto kernel = nt_kernel<T, kVec, RR>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid((Nc + bn - 1) / bn, (M + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, s>>>(g, b, out, M, Nc, R, bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kVec, int RR>
int run_tn(const T* a, const T* g, T* out, int Mo, int N, int R, int bm,
           int bk, int bn, cudaStream_t s) {
  static int smem_set = 48 * 1024;
  const int smem = 2 * bk * (bm + bn) * int(sizeof(T));
  auto kernel = tn_kernel<T, kVec, RR>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid((N + bn - 1) / bn, (Mo + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, s>>>(a, g, out, Mo, N, R, bm, bk, bn);
  return static_cast<int>(cudaGetLastError());
}

#define DGRAD_ROWS(RUN, T, V, ...)                                        \
  if (rows <= 1) return RUN<T, V, 1>(__VA_ARGS__);                        \
  if (rows <= 2) return RUN<T, V, 2>(__VA_ARGS__);                        \
  if (rows <= 4) return RUN<T, V, 4>(__VA_ARGS__);                        \
  if (rows <= 8) return RUN<T, V, 8>(__VA_ARGS__);                        \
  return RUN<T, V, kMaxRows>(__VA_ARGS__);

template <typename T>
int dgrad_a(const void* g, const void* b, void* out, int M, int N, int K,
            int bm, int br, int bo, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int rows = thread_rows(bm, bo);
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = gemm::aligned16(g) && gemm::aligned16(b) && N % V == 0 &&
                   br % V == 0;
  const T* G = static_cast<const T*>(g);
  const T* B = static_cast<const T*>(b);
  T* O = static_cast<T*>(out);
  if (vec) {
    DGRAD_ROWS(run_nt, T, true, G, B, O, M, K, N, bm, br, bo, s)
  }
  DGRAD_ROWS(run_nt, T, false, G, B, O, M, K, N, bm, br, bo, s)
}

template <typename T>
int dgrad_b(const void* a, const void* g, void* out, int M, int N, int K,
            int bk, int br, int bn, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const int rows = thread_rows(bk, bn);
  if (rows < 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = gemm::aligned16(a) && gemm::aligned16(g) && K % V == 0 &&
                   N % V == 0 && bk % V == 0 && bn % V == 0;
  const T* A = static_cast<const T*>(a);
  const T* G = static_cast<const T*>(g);
  T* O = static_cast<T*>(out);
  if (vec) {
    DGRAD_ROWS(run_tn, T, true, A, G, O, K, N, M, bk, br, bn, s)
  }
  DGRAD_ROWS(run_tn, T, false, A, G, O, K, N, M, bk, br, bn, s)
}

#undef DGRAD_ROWS

inline bool bad_dims(int M, int N, int K, int t0, int t1, int t2) {
  return M <= 0 || N <= 0 || K <= 0 || t0 <= 0 || t1 <= 0 || t2 <= 0;
}

}  // namespace

// dA[M, K] = g[M, N] @ b[K, N]^T, tiled bm rows (of M), br of the
// reduction (N), bo columns (of K).  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int matmul_dgrad_a(int dtype, const void* g, const void* b,
                              void* out, int M, int N, int K, int bm, int br,
                              int bo, void* stream) {
  if (bad_dims(M, N, K, bm, br, bo))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dgrad_a<float>(g, b, out, M, N, K, bm, br, bo, s);
  if (dtype == 1)
    return dgrad_a<__nv_bfloat16>(g, b, out, M, N, K, bm, br, bo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dB[K, N] = a[M, K]^T @ g[M, N], tiled bk rows (of K), br of the
// reduction (M), bn columns (of N).  dtype: 0 = float32, 1 = bfloat16.
// Returns a cudaError_t.
extern "C" int matmul_dgrad_b(int dtype, const void* a, const void* g,
                              void* out, int M, int N, int K, int bk, int br,
                              int bn, void* stream) {
  if (bad_dims(M, N, K, bk, br, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dgrad_b<float>(a, g, out, M, N, K, bk, br, bn, s);
  if (dtype == 1)
    return dgrad_b<__nv_bfloat16>(a, g, out, M, N, K, bk, br, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
