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
// its fp32 sums in registers -- the paper's output-buffer rule: for dB
// the reduction runs over all of M = B * S inside one block, in a fixed
// order, with no atomics and no split reduction, so repeated launches
// agree bit for bit.  Tiles (bm, bk, bn) are runtime arguments in the
// "matmul_dgrad" key's (M_out, K_reduce, N_out) roles; ragged edges are
// masked, so every shape launches (the JAX op falls back to jnp.dot on
// ragged tiles).  256 threads a block; the next step's tiles are copied
// by cp.async while the current one is multiplied.
//
// Bound on this card: at the training shapes (M = 2048 tokens, granite's
// projections) both are bound by operations: 2 M N K flops over a few
// tens of MB (the up projection's cotangent, (M, N, K) = (2048, 12800,
// 4096): 214.7 GFLOP, 0.2171 ms at the 989 TFLOP/s bf16 peak).
//
// bf16 (nt_mma_kernel, tn_mma_kernel): the tensor cores, mma.sync
// m16n8k16 with fp32 sums through the fragment core of gemm_mma.cuh.  The
// 8 warps tile the output as mma_layout's wm x wn grid of mt m16 x nt n8
// fragments (at the model's (128, 64, 128): 4 x 2 warps of 32 x 64, 64
// sums a thread, two blocks an SM); the reduction step is staged in
// whole k16 steps, zero-filled, 2 or 3 buffers deep; every staged row is
// XOR-swizzled by 16-byte chunk so the 8 rows of each ldmatrix
// sub-matrix hit 8 bank groups.
// * NT stages both tiles as they lie: bm rows of g and bn rows of B (one
//   per output column), each a step of reduction elements -- the
//   row.col layout mma.sync wants, so A and B fragments come by plain
//   ldmatrix.
// * TN stages both tiles reduction-major: a step of rows of A (bm wide)
//   and of g (bn wide); A and B fragments come by ldmatrix.trans.
// What this does about the bound: every multiply-add is a tensor-core
// one (the CUDA-core loop reached 26 TFLOP/s, under the CUDA cores' own
// 67); each fragment feeds nt or mt mma's from one shared-memory load.
// This is mma.sync, not wgmma: every warp re-reads its fragments from
// shared memory each k16 step, which bounds it well below the card's
// peak; wgmma with TMA-fed tiles is the later step.
//
// fp32 (nt_kernel, tn_kernel): CUDA cores.  TF32 tensor cores would
// round the operands to 10 mantissa bits and break the fp32 tolerances,
// so fp32 multiplies in fp32: each thread holds up to 16 rows x 4
// columns of the tile (gemm_tile.cuh's layout), two stages of tiles.
// * NT stages both tiles as they lie, the 16-byte chunks of a row
//   XOR-swizzled by the row index so that the compute loop's reads of 4
//   consecutive reduction elements of 8 different rows hit 8 different
//   bank groups.  A thread holds the strided columns cg, cg + ncg, ...
//   (the rows of B a quarter warp reads are then 8 consecutive ones).
// * TN stages bk rows of A (bm wide) and bk rows of g (bn wide): the
//   compute loop is the forward's with A's tile read down a column.
#include "gemm_mma.cuh"
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

// ------------------------------------------------- bf16: tensor cores --

using gemm_mma::bf16;
using gemm_mma::ceil_div;
using gemm_mma::Layout;
using gemm_mma::Tile;

// out[M, Nc] = G[M, R] @ B[Nc, R]^T; block (x, y) owns columns x * bn and
// rows y * bm.  bm rows of G and bn rows of B, a step of the reduction
// each; rows past the tile read its last row and are never stored.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
nt_mma_kernel(const bf16* __restrict__ G, const bf16* __restrict__ B,
              bf16* __restrict__ out, int M, int Nc, int R, int bm, int bk,
              int bn, int wn_count, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t(gemm_mma::round_up(bk, 16) / 8);
  const int stage = (bm + bn) * t.ld;  // chunks of one buffer
  bf16* const base = reinterpret_cast<bf16*>(smem);
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int m_ok = min(bm, M - m0), n_ok = min(bn, Nc - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;

  // A: lane supplies row lane & 15 of each m16 tile at k-half lane >> 4;
  // B: of each pair of n8 tiles, row (lane & 7) + 8 (lane >> 4) at k-half
  // (lane >> 3) & 1.  Chunk 2 ks + half of row r sits at r * ld +
  // ((2 ks) ^ half ^ swz(r)): keep r * ld and half ^ swz(r).
  constexpr int NP = (NT + 1) / 2;
  int a_row[MT], a_x[MT], b_row[NP], b_x[NP];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min((wm * MT + mt) * 16 + (lane & 15), bm - 1);
    a_row[mt] = r * t.ld;
    a_x[mt] = (lane >> 4) ^ t.swz(r);
  }
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const int r =
        min((wn * NT + 2 * j) * 8 + (lane & 7) + ((lane >> 4) << 3), bn - 1);
    b_row[j] = (bm + r) * t.ld;
    b_x[j] = ((lane >> 3) & 1) ^ t.swz(r);
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int ksteps = t.w / 2;
  const uint32_t s0 = mma::smem_addr(base);
  gemm_mma::pipeline(
      ceil_div(R, bk), stages,
      [&](int buf, int step) {
        bf16* const st = base + buf * stage * 8;
        const int k0 = step * bk, k_ok = min(bk, R - k0);
        gemm_mma::stage(st, G, R, m0, bm, m_ok, k0, k_ok, t, vec);
        gemm_mma::stage(st + bm * t.ld * 8, B, R, n0, bn, n_ok, k0, k_ok, t,
                        vec);
      },
      [&](int buf) {
        const uint32_t st = s0 + buf * stage * 16;
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          gemm_mma::mma_step<MT, NT, false>(
              acc,
              [&](int mt) {
                return st + (a_row[mt] + ((2 * ks) ^ a_x[mt])) * 16;
              },
              [&](int j) {
                return st + (b_row[j] + ((2 * ks) ^ b_x[j])) * 16;
              });
        }
      });
  gemm_mma::store(acc, out, Nc, m0, n0, m_ok, n_ok, wm, wn, lane);
}

// out[Mo, N] = A[R, Mo]^T @ G[R, N]; block (x, y) owns columns x * bn and
// rows y * bm.  A step of rows of A (bm wide) and of G (bn wide), each
// rounded up to whole chunks; fragments past the tile read its last
// chunk and are never stored.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
tn_mma_kernel(const bf16* __restrict__ A, const bf16* __restrict__ G,
              bf16* __restrict__ out, int Mo, int N, int R, int bm, int bk,
              int bn, int wn_count, int stages, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = gemm_mma::round_up(bk, 16);
  const Tile ta(ceil_div(bm, 8)), tg(ceil_div(bn, 8));
  const int a_size = bkp * ta.ld, stage = bkp * (ta.ld + tg.ld);  // chunks
  bf16* const base = reinterpret_cast<bf16*>(smem);
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int m_ok = min(bm, Mo - m0), n_ok = min(bn, N - n0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;

  // ldmatrix.trans sub-matrix i = lane >> 3: for A, k rows 8 (i >> 1) ..
  // of the k16 step at the m16 tile's chunk i & 1; for a pair of n8 B
  // tiles, k rows 8 (i & 1) .. at the pair's chunk i >> 1.  The swizzle
  // of row 16 ks + k is that of k (the XOR term reads bits below 16), so
  // each lane's offset within a k16 step is fixed.
  constexpr int NP = (NT + 1) / 2;
  const int i = lane >> 3;
  const int ka = (lane & 7) + ((i >> 1) << 3);
  const int kb = (lane & 7) + ((i & 1) << 3);
  int a_off[MT], b_off[NP];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_off[mt] = ka * ta.ld +
                (min(2 * (wm * MT + mt) + (i & 1), ta.w - 1) ^ ta.swz(ka));
#pragma unroll
  for (int j = 0; j < NP; ++j)
    b_off[j] = a_size + kb * tg.ld +
               (min(wn * NT + 2 * j + (i >> 1), tg.w - 1) ^ tg.swz(kb));
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int ksteps = bkp / 16;
  const uint32_t s0 = mma::smem_addr(base);
  gemm_mma::pipeline(
      ceil_div(R, bk), stages,
      [&](int buf, int step) {
        bf16* const st = base + buf * stage * 8;
        const int k0 = step * bk, k_ok = min(bk, R - k0);
        gemm_mma::stage(st, A, Mo, k0, bkp, k_ok, m0, m_ok, ta, vec);
        gemm_mma::stage(st + a_size * 8, G, N, k0, bkp, k_ok, n0, n_ok, tg,
                        vec);
      },
      [&](int buf) {
        const uint32_t st = s0 + buf * stage * 16;
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint32_t sa = st + ks * 16 * ta.ld * 16;
          const uint32_t sg = st + ks * 16 * tg.ld * 16;
          gemm_mma::mma_step<MT, NT, true>(
              acc, [&](int mt) { return sa + a_off[mt] * 16; },
              [&](int j) { return sg + b_off[j] * 16; });
        }
      });
  gemm_mma::store(acc, out, N, m0, n0, m_ok, n_ok, wm, wn, lane);
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

// dynamic shared memory of the bf16 kernels: `stages` buffers of both
// staged tiles (kernels/matmul_bwd.py::smem_bytes_required)
inline int nt_mma_smem(int bm, int bk, int bn, int stages) {
  return stages * (bm + bn) * Tile(gemm_mma::round_up(bk, 16) / 8).ld * 16;
}
inline int tn_mma_smem(int bm, int bk, int bn, int stages) {
  return stages * gemm_mma::round_up(bk, 16) *
         (Tile(ceil_div(bm, 8)).ld + Tile(ceil_div(bn, 8)).ld) * 16;
}

// one bf16 dgrad launch: out (M x N) reduced over R, tiles (bm, bk, bn)
struct MmaArgs {
  const bf16* x;
  const bf16* y;
  bf16* out;
  int M, N, R, bm, bk, bn, stages, vec;
  cudaStream_t stream;
};

template <bool kTN, int MT, int NT>
int launch_mma(const MmaArgs& a, int wn) {
  static int smem_set = 48 * 1024;
  const int smem = kTN ? tn_mma_smem(a.bm, a.bk, a.bn, a.stages)
                       : nt_mma_smem(a.bm, a.bk, a.bn, a.stages);
  auto kernel = nt_mma_kernel<MT, NT>;
  if constexpr (kTN) kernel = tn_mma_kernel<MT, NT>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid(ceil_div(a.N, a.bn), ceil_div(a.M, a.bm));
  kernel<<<grid, kThreads, smem, a.stream>>>(a.x, a.y, a.out, a.M, a.N, a.R,
                                             a.bm, a.bk, a.bn, wn, a.stages,
                                             a.vec);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the layout's (mt, nt): mt <= 8, nt a power of two <= 8,
// mt * nt <= 16 (22 pairs, each for NT and TN)
template <bool kTN, int MT = 1, int NT = 1>
int dispatch_mma(const MmaArgs& a, const Layout& l) {
  if constexpr (MT * NT <= gemm_mma::kMaxFrags) {
    if (l.mt == MT && l.nt == NT) return launch_mma<kTN, MT, NT>(a, l.wn);
  }
  if constexpr (NT < gemm_mma::kMaxNt)
    return dispatch_mma<kTN, MT, NT * 2>(a, l);
  else if constexpr (MT < gemm_mma::kMaxMt)
    return dispatch_mma<kTN, MT + 1, 1>(a, l);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool kTN>
int dgrad_mma(const void* x, const void* y, void* out, int M, int N, int R,
              int t_rows, int t_red, int t_cols, int stages, bool vec,
              cudaStream_t s) {
  const Layout l = gemm_mma::mma_layout(t_rows, t_cols);
  if (l.wm == 0 || (stages != 2 && stages != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(y),
                  static_cast<bf16*>(out), M, N, R, t_rows, t_red, t_cols,
                  stages, vec, s};
  return dispatch_mma<kTN>(a, l);
}

inline bool bad_dims(int M, int N, int K, int t0, int t1, int t2) {
  return M <= 0 || N <= 0 || K <= 0 || t0 <= 0 || t1 <= 0 || t2 <= 0;
}

}  // namespace

// dA[M, K] = g[M, N] @ b[K, N]^T, tiled bm rows (of M), br of the
// reduction (N), bo columns (of K).  dtype: 0 = float32 (the CUDA cores,
// stages 2), 1 = bfloat16 (the tensor cores, stages 2 or 3).  Returns a
// cudaError_t.
extern "C" int matmul_dgrad_a(int dtype, const void* g, const void* b,
                              void* out, int M, int N, int K, int bm, int br,
                              int bo, int stages, void* stream) {
  if (bad_dims(M, N, K, bm, br, bo))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stages == 2)
    return dgrad_a<float>(g, b, out, M, N, K, bm, br, bo, s);
  if (dtype == 1) {
    const bool vec = gemm::aligned16(g) && gemm::aligned16(b) &&
                     N % 8 == 0 && br % 8 == 0;
    return dgrad_mma<false>(g, b, out, M, K, N, bm, br, bo, stages, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dB[K, N] = a[M, K]^T @ g[M, N], tiled bk rows (of K), br of the
// reduction (M), bn columns (of N).  dtype and stages as for dA.
// Returns a cudaError_t.
extern "C" int matmul_dgrad_b(int dtype, const void* a, const void* g,
                              void* out, int M, int N, int K, int bk, int br,
                              int bn, int stages, void* stream) {
  if (bad_dims(M, N, K, bk, br, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stages == 2)
    return dgrad_b<float>(a, g, out, M, N, K, bk, br, bn, s);
  if (dtype == 1) {
    const bool vec = gemm::aligned16(a) && gemm::aligned16(g) &&
                     K % 8 == 0 && N % 8 == 0 && bk % 8 == 0 && bn % 8 == 0;
    return dgrad_mma<true>(a, g, out, K, N, M, bk, br, bn, stages, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
