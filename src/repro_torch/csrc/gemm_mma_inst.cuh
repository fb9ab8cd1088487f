// The two bf16 tensor-core instances of the forward GEMM, Y[M, N] = A[M,
// K] @ W[K, N] (A bf16, W bf16 or int8, both row-major), on gemm_mma.cuh's
// fragment core: kernel rows 6 (matmul_blocked.cu, matmul_blocked_mma.cu),
// 9 (matmul_fused.cu, matmul_fused_mma.cu), 10 (matmul_w8.cu,
// matmul_w8_mma.cu) and 11 (qkv_fused.cu, qkv_fused_mma.cu) instantiate
// them.  What differs per row is two small structs passed by value to the
// kernel:
//   Src, the per-block weight source: block(x, bn) is column block x's
//     WBlock -- its weight matrix, that matrix's row stride, the block's
//     first column in it and its columns in range (n_ok <= bn) -- and
//     blocks(bn), on the host, the grid's column blocks.  OneW is one
//     matrix of N columns (rows 6, 9 and 10); row 11's source walks the
//     q, k and v weights one segment after the other.
//   Map, the store: store(m, c, acc) writes row m, column c (< n_ok) of
//     block blockIdx.x's tile from its fp32 sum, the epilogue included:
//     BlockedMap (below, row 6: the sum cast once), FusedMap
//     (fused_gemm.cuh, row 9), W8Map (below, row 10), QkvBlocks (below,
//     row 11: source and map in one).  Each row's map has a name of its
//     own, so a profile tells the rows' kernels apart.
// Both are __grid_constant__ kernel parameters: their member calls take
// their address, which would otherwise copy them to each thread's local
// memory (on an H100 that made row 9's decode 1.5-3% slower).
// gemm_tile.cuh's 16-byte-chunk contract holds block by block: with vec
// (or an int8 W, always staged by 16-byte copies) a block's columns [n0,
// n0 + n_ok) are whole chunks of one matrix -- n0, n_ok and the stride
// multiples of 8 bf16 (16 int8) -- so the chunks of one copy share one
// source and are all in range or all out.  One block walks the whole K
// in a fixed order (no split-K, no atomics), so repeated launches agree
// bit for bit.
//
// * "mma" (mma_kernel, M > 16): the 8 warps tile the (bm, bn) output as
//   mma_layout's wm x wn grid of mt m16 x nt n8 fragments; each reduction
//   step stages bm rows of A (plain ldmatrix, as the dgrad's NT kernel)
//   and bk rows of W (ldmatrix.trans, as its TN kernel), 16-byte chunks
//   XOR-swizzled by row, 2 or 3 cp.async stages.
// * "mma_t" (mma_t_kernel, M <= 16): decode.  An m16 fragment of tokens
//   would be at least half empty, and output tiles wide enough to feed it
//   leave most of the 132 SMs idle.  The block computes the transposed
//   product Y^T = W^T . A^T: its bn = 16 MT columns of W sit on the m16
//   side (A fragments by ldmatrix.trans of the staged [bk][bn] W tile),
//   the M tokens are NT = 1 or 2 n8 tiles (B fragments by plain ldmatrix
//   of the staged token rows; slots past M stage as zero and are never
//   stored).  The 8 warps split each stage's k16 steps among themselves
//   and, after the last, sum their C fragments through shared memory in
//   warp order; 2 to 4 cp.async stages.
// An int8 W (both instances) is staged raw, bn / 16 chunks a row (one
// byte a weight in HBM and L2), and widened to bf16 by one pass over the
// staged tile into a swizzled bf16 tile (exact: |q| <= 127 fits bf16's
// 8-bit significand), then read as a wide one.
#pragma once

#include "gemm_mma.cuh"

namespace mma_inst {

using gemm_mma::bf16;
using gemm_mma::ceil_div;
using gemm_mma::Layout;
using gemm_mma::round_up;
using gemm_mma::Tile;

constexpr int kTMaxRows = 16;  // tokens of the transposed instance

// A column block's weight: W[k][n0 + c] for c < n_ok is at w + k * ld +
// n0 + c (elements of the matrix's own type)
struct WBlock {
  const void* w;
  int64_t ld;
  int n0, n_ok;
};

// One weight matrix of N columns: column block x is columns [x bn, x bn +
// bn) of it, cut at N
struct OneW {
  const void* w;
  int N;
  __device__ WBlock block(int x, int bn) const {
    const int n0 = x * bn;
    return {w, N, n0, min(bn, N - n0)};
  }
  int blocks(int bn) const { return ceil_div(N, bn); }
};

// four int8 (one word) as four bf16 (two words), exactly: byte b + 128
// becomes the low mantissa byte of 2^23 (gemm_tile.cuh's load4), and
// every integer of magnitude <= 256 is a bf16
__device__ __forceinline__ uint2 widen4(unsigned u) {
  u ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443));
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(f0 - 8388736.f, f1 - 8388736.f);
  const __nv_bfloat162 hi =
      __floats2bfloat162_rn(f2 - 8388736.f, f3 - 8388736.f);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

// Stage rows [0, nr) of an int8 tile, w16 16-byte chunks a row, in rows
// of w16 chunks (unswizzled): chunk c of row r is W[(r0 + r) * ldw + c0 +
// 16 c ..] for r < r_ok and 16 c < c_ok (whole chunks), else zero.
__device__ __forceinline__ void stage_i8(int8_t* s, const int8_t* W,
                                         int64_t ldw, int r0, int nr,
                                         int r_ok, int c0, int c_ok,
                                         int w16) {
  const uint32_t base = mma::smem_addr(s);
  for (int i = threadIdx.x; i < nr * w16; i += gemm_mma::kThreads) {
    const int r = i / w16, c = i - r * w16;
    const bool in = r < r_ok && c * 16 < c_ok;
    const int8_t* src = in ? W + int64_t(r0 + r) * ldw + c0 + c * 16 : W;
    gemm_mma::cp_async16_zfill(base + i * 16, src, in ? 16 : 0);
  }
}

// Widen a staged int8 tile (nr rows of w16 chunks) into the bf16 tile t
// (rows of 2 w16 chunks, swizzled as Tile lays them out).
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src, int nr,
                                      int w16, const Tile& t) {
  for (int i = threadIdx.x; i < nr * w16; i += gemm_mma::kThreads) {
    const int r = i / w16, c = i - r * w16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + i * 16);
    const uint2 a = widen4(u.x), b = widen4(u.y);
    const uint2 c2 = widen4(u.z), d = widen4(u.w);
    *reinterpret_cast<uint4*>(dst + t.at(r, 2 * c) * 8) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(dst + t.at(r, 2 * c + 1) * 8) =
        make_uint4(c2.x, c2.y, d.x, d.y);
  }
}

// Stage one step of a column block's W: the swizzled bf16 tile t, or
// for an int8 W its raw rows of bn / 16 chunks.
__device__ __forceinline__ void stage_w(bf16* s, const WBlock& b, int k0,
                                        int bkp, int k_ok, int bn,
                                        const Tile& t, int vec, int w8) {
  if (w8)
    stage_i8(reinterpret_cast<int8_t*>(s), static_cast<const int8_t*>(b.w),
             b.ld, k0, bkp, k_ok, b.n0, b.n_ok, bn / 16);
  else
    gemm_mma::stage(s, static_cast<const bf16*>(b.w), b.ld, k0, bkp, k_ok,
                    b.n0, b.n_ok, t, vec);
}

// 16-byte chunks of one staged W step of bkp rows and bn columns: the
// swizzled bf16 tile, or the raw int8 rows
__host__ __device__ inline int w_chunks(int bkp, int bn, bool w8) {
  return w8 ? bkp * (bn / 16) : bkp * Tile(ceil_div(bn, 8)).ld;
}

// Dynamic shared memory of both instances (kernels/matmul_fused.py::
// smem_bytes_required): `stages` buffers of `rows` rows of A and one step
// of W, the widened W tile of an int8 W; mma_t's warp sums overlay them.
inline int mma_smem(int rows, int bk, int bn, int stages, bool w8) {
  const int bkp = round_up(bk, 16);
  const int stage = rows * Tile(bkp / 8).ld + w_chunks(bkp, bn, w8);
  return (stages * stage + (w8 ? bkp * Tile(ceil_div(bn, 8)).ld : 0)) * 16;
}
inline int mma_t_smem(int nt, int bk, int bn, int stages, bool w8) {
  const int sums = gemm_mma::kWarps * (bn / 16) * nt * 4 * 32 * 4;
  const int staged = mma_smem(8 * nt, bk, bn, stages, w8);
  return staged > sums ? staged : sums;
}

// the store of a warp's fragments, element by element through the map:
// rows from the tile's mt0-th m16 tile, columns from its nt0-th n8 tile
template <int MT, int NT, class Map>
__device__ __forceinline__ void store_frags(const float (&d)[MT][NT][4],
                                            const Map& map, int m0,
                                            int m_ok, int n_ok, int mt0,
                                            int nt0, int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (mt0 + mt) * 16 + g + hr * 8;
      if (r >= m_ok) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = (nt0 + nt) * 8 + c2 + e;
          if (c < n_ok) map.store(m0 + r, c, d[mt][nt][hr * 2 + e]);
        }
    }
}

// ----------------------------------------------------- "mma", M > 16 --

// Y tiled (bm, bk, bn); block (x, y) owns column block x and rows y * bm.
// One stage: bm rows of A (bkp / 8 chunks each, tx), then bkp rows of W
// (tw; int8: bn / 16 raw chunks each); an int8 W adds one widened tile
// after the stages.  Rows and columns past the tile read its last one
// and are never stored.
template <int MT, int NT, class Src, class Map>
__global__ void __launch_bounds__(gemm_mma::kThreads, 2)
mma_kernel(const bf16* __restrict__ A, const __grid_constant__ Src src,
           const __grid_constant__ Map map, int M, int K,
           int bm, int bk, int bn, int wn_count, int stages, int vec,
           int w8) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = round_up(bk, 16);
  const Tile tx(bkp / 8), tw(ceil_div(bn, 8));
  const int x_size = bm * tx.ld;                     // chunks
  const int stage = x_size + w_chunks(bkp, bn, w8);  // chunks
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16* const wide = base + stages * stage * 8;      // int8: widened W
  const WBlock wb = src.block(blockIdx.x, bn);
  const int m0 = blockIdx.y * bm, m_ok = min(bm, M - m0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;

  // A: lane supplies row lane & 15 of each m16 tile at k-half lane >> 4
  // (chunk 2 ks + half of row r at r * ld + ((2 ks) ^ half ^ swz(r)));
  // B: ldmatrix.trans sub-matrix i = lane >> 3 of a pair of n8 tiles
  // reads k rows 8 (i & 1) .. at the pair's chunk i >> 1, and the
  // swizzle of row 16 ks + k is that of k
  constexpr int NP = (NT + 1) / 2;
  int a_row[MT], a_x[MT], b_off[NP];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r = min((wm * MT + mt) * 16 + (lane & 15), bm - 1);
    a_row[mt] = r * tx.ld;
    a_x[mt] = (lane >> 4) ^ tx.swz(r);
  }
  const int i = lane >> 3, kb = (lane & 7) + ((i & 1) << 3);
#pragma unroll
  for (int j = 0; j < NP; ++j)
    b_off[j] = kb * tw.ld +
               (min(wn * NT + 2 * j + (i >> 1), tw.w - 1) ^ tw.swz(kb));
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int ksteps = bkp / 16;
  const uint32_t s0 = mma::smem_addr(base), s_wide = mma::smem_addr(wide);
  gemm_mma::pipeline(
      ceil_div(K, bk), stages,
      [&](int buf, int step) {
        bf16* const st = base + buf * stage * 8;
        const int k0 = step * bk, k_ok = min(bk, K - k0);
        gemm_mma::stage(st, A, K, m0, bm, m_ok, k0, k_ok, tx, vec);
        stage_w(st + x_size * 8, wb, k0, bkp, k_ok, bn, tw, vec, w8);
      },
      [&](int buf) {
        const uint32_t st = s0 + buf * stage * 16;
        uint32_t sw = st + x_size * 16;
        if (w8) {
          widen(wide,
                reinterpret_cast<const int8_t*>(base +
                                                (buf * stage + x_size) * 8),
                bkp, bn / 16, tw);
          __syncthreads();  // the widened tile is complete
          sw = s_wide;
        }
#pragma unroll 2
        for (int ks = 0; ks < ksteps; ++ks) {
          const uint32_t swk = sw + ks * 16 * tw.ld * 16;
          gemm_mma::mma_step_ab_t<MT, NT>(
              acc,
              [&](int mt) {
                return st + (a_row[mt] + ((2 * ks) ^ a_x[mt])) * 16;
              },
              [&](int j) { return swk + b_off[j] * 16; });
        }
      });
  store_frags(acc, map, m0, m_ok, wb.n_ok, wm * MT, wn * NT, lane);
}

// ---------------------------------- "mma_t", M <= 16: the transposed one --

// Y[M, N] for M <= 16 as Y^T = W^T . A^T; block x owns column block x of
// BN = 16 MT columns.  One stage: the 8 NT token rows of A (bkp / 8
// chunks each, tx; rows past M zero), then bkp rows of W (tw; int8: BN /
// 16 raw chunks each); an int8 W adds one widened tile.  Warp w
// multiplies k16 steps w, w + 8, ... of each stage; the warps' sums are
// added in warp order after the last.
template <int MT, int NT, class Src, class Map>
__global__ void __launch_bounds__(gemm_mma::kThreads)
mma_t_kernel(const bf16* __restrict__ A, const __grid_constant__ Src src,
             const __grid_constant__ Map map, int M, int K,
             int bk, int stages, int vec, int w8) {
  constexpr int BN = 16 * MT, XR = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = round_up(bk, 16);
  const Tile tx(bkp / 8), tw(BN / 8);
  const int x_size = XR * tx.ld;                     // chunks
  const int stage = x_size + w_chunks(bkp, BN, w8);  // chunks
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16* const wide = base + stages * stage * 8;      // int8: widened W
  const WBlock wb = src.block(blockIdx.x, BN);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // A (W^T): ldmatrix.trans sub-matrix i = lane >> 3 reads k rows
  // 8 (i >> 1) .. of the k16 step at W column chunk 2 mt + (i & 1);
  // B (A^T): plain ldmatrix of token row (lane & 7) + 8 (lane >> 4) at
  // k-half (lane >> 3) & 1 (one n8 tile: lanes 0-15, ldmatrix.x2)
  const int i = lane >> 3, ka = (lane & 7) + ((i >> 1) << 3);
  int a_off[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    a_off[mt] = ka * tw.ld + ((2 * mt + (i & 1)) ^ tw.swz(ka));
  const int rb = (lane & 7) + (NT == 2 ? (lane >> 4) << 3 : 0);
  const int b_row = rb * tx.ld, b_x = ((lane >> 3) & 1) ^ tx.swz(rb);
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int ksteps = bkp / 16;
  const uint32_t s0 = mma::smem_addr(base), s_wide = mma::smem_addr(wide);
  gemm_mma::pipeline(
      ceil_div(K, bk), stages,
      [&](int buf, int step) {
        bf16* const st = base + buf * stage * 8;
        const int k0 = step * bk, k_ok = min(bk, K - k0);
        gemm_mma::stage(st, A, K, 0, XR, M, k0, k_ok, tx, vec);
        stage_w(st + x_size * 8, wb, k0, bkp, k_ok, BN, tw, vec, w8);
      },
      [&](int buf) {
        const uint32_t st = s0 + buf * stage * 16;
        uint32_t sw = st + x_size * 16;
        if (w8) {
          widen(wide,
                reinterpret_cast<const int8_t*>(base +
                                                (buf * stage + x_size) * 8),
                bkp, BN / 16, tw);
          __syncthreads();  // the widened tile is complete
          sw = s_wide;
        }
        for (int ks = warp; ks < ksteps; ks += gemm_mma::kWarps) {
          uint32_t b[4];
          const uint32_t bx = st + (b_row + ((2 * ks) ^ b_x)) * 16;
          if constexpr (NT == 2)
            mma::ldmatrix_x4(b, bx);
          else
            mma::ldmatrix_x2(b[0], b[1], bx);
          const uint32_t swk = sw + ks * 16 * tw.ld * 16;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            uint32_t a[4];
            mma::ldmatrix_x4_trans(a, swk + a_off[mt] * 16);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma::mma_bf16_16816(acc[mt][nt], a, b[2 * nt], b[2 * nt + 1]);
          }
        }
      });

  // the warps' sums, added in warp order: [warp][mt][nt][e][lane]
  constexpr int F = MT * NT * 4 * 32;
  float* const red = reinterpret_cast<float*>(smem);
  __syncthreads();  // every warp is done with the staged tiles
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[warp * F + ((mt * NT + nt) * 4 + e) * 32 + lane] = acc[mt][nt][e];
  __syncthreads();
  for (int x = threadIdx.x; x < F; x += gemm_mma::kThreads) {
    float s = red[x];
    for (int w = 1; w < gemm_mma::kWarps; ++w) s += red[w * F + x];
    const int l = x & 31, f = x >> 5, e = f & 3;
    const int nt = (f >> 2) % NT, mt = (f >> 2) / NT;
    const int col = mt * 16 + (l >> 2) + 8 * (e >> 1);  // of W, in the tile
    const int tok = nt * 8 + 2 * (l & 3) + (e & 1);
    if (tok < M && col < wb.n_ok) map.store(tok, col, s);
  }
}

// ------------------------------------------------------------ launches --

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

// One launch's arguments.  vec: A and a wide W by 16-byte copies (the
// caller checks alignment and whole chunks); w8: W is int8.
template <class Src, class Map> struct Args {
  const bf16* a;
  Src src;
  Map map;
  int M, K, bm, bk, bn, stages, vec, w8;
  cudaStream_t stream;
};

template <int MT, int NT, class Src, class Map>
int launch_mma(const Args<Src, Map>& a, int wn) {
  static int smem_set = 48 * 1024;
  const int smem = mma_smem(a.bm, a.bk, a.bn, a.stages, a.w8);
  auto kernel = mma_kernel<MT, NT, Src, Map>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid(a.src.blocks(a.bn), ceil_div(a.M, a.bm));
  kernel<<<grid, gemm_mma::kThreads, smem, a.stream>>>(
      a.a, a.src, a.map, a.M, a.K, a.bm, a.bk, a.bn, wn, a.stages, a.vec,
      a.w8);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the layout's (mt, nt): mt <= 8, nt a power of two <= 8,
// mt * nt <= 16 (22 pairs; matmul_bwd.cu's set)
template <int MT = 1, int NT = 1, class Src, class Map>
int dispatch_mma(const Args<Src, Map>& a, const Layout& l) {
  if constexpr (MT * NT <= gemm_mma::kMaxFrags) {
    if (l.mt == MT && l.nt == NT) return launch_mma<MT, NT>(a, l.wn);
  }
  if constexpr (NT < gemm_mma::kMaxNt)
    return dispatch_mma<MT, NT * 2>(a, l);
  else if constexpr (MT < gemm_mma::kMaxMt)
    return dispatch_mma<MT + 1, 1>(a, l);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

// "mma": M > 16, 2 or 3 stages, a (bm, bn) tile on mma_layout's grid
template <class Src, class Map> int run_mma(const Args<Src, Map>& a) {
  if (a.M <= kTMaxRows || (a.stages != 2 && a.stages != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = gemm_mma::mma_layout(a.bm, a.bn);
  if (l.wm == 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_mma(a, l);
}

template <int MT, int NT, class Src, class Map>
int launch_mma_t(const Args<Src, Map>& a) {
  static int smem_set = 48 * 1024;
  const int smem = mma_t_smem(NT, a.bk, a.bn, a.stages, a.w8);
  auto kernel = mma_t_kernel<MT, NT, Src, Map>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid(a.src.blocks(a.bn), 1);
  kernel<<<grid, gemm_mma::kThreads, smem, a.stream>>>(
      a.a, a.src, a.map, a.M, a.K, a.bk, a.stages, a.vec, a.w8);
  return static_cast<int>(cudaGetLastError());
}

// bn = 16, 32, 64 or 128 W columns; NT = 1 (M <= 8) or 2 token tiles
template <int NT, class Src, class Map>
int dispatch_mma_t(const Args<Src, Map>& a) {
  switch (a.bn) {
    case 16: return launch_mma_t<1, NT>(a);
    case 32: return launch_mma_t<2, NT>(a);
    case 64: return launch_mma_t<4, NT>(a);
    case 128: return launch_mma_t<8, NT>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// "mma_t": M <= 16, 2 to 4 stages
template <class Src, class Map> int run_mma_t(const Args<Src, Map>& a) {
  if (a.M > kTMaxRows || a.stages < 2 || a.stages > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  return a.M <= 8 ? dispatch_mma_t<1>(a) : dispatch_mma_t<2>(a);
}

// ---------------------------------- the sources and maps of rows 6, 10, 11 --

// Row 6's store: C[m, col] = the fp32 sum, cast once to bf16 (no
// epilogue: matmul_ref's order).
struct BlockedMap {
  bf16* C;
  int N, bn;
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col < N) C[int64_t(m) * N + col] = __float2bfloat16(acc);
  }
};

inline Args<OneW, BlockedMap> blocked_args(const void* a, const void* b,
                                           void* c, int M, int N, int K,
                                           int bm, int bk, int bn,
                                           int stages, cudaStream_t stream) {
  const bool vec = gemm::aligned16(a) && gemm::aligned16(b) && K % 8 == 0 &&
                   bk % 8 == 0 && N % 8 == 0 && bn % 8 == 0;
  return {static_cast<const bf16*>(a), OneW{b, N},
          BlockedMap{static_cast<bf16*>(c), N, bn},
          M, K, bm, bk, bn, stages, vec, 0, stream};
}

// Row 10's store: C[m, col] = acc * scale[col], the scale once in fp32,
// then one cast (matmul_w8_ref's order).  b_col is gemm_tile.cuh's Map
// interface (the fp32 instance); the tensor-core instances stage W
// through OneW and call store only.
template <typename T> struct W8Map {
  const int8_t* W;
  T* C;
  const float* scale;  // (N,)
  int N, bn;
  __device__ gemm::ColRef<int8_t> b_col(int c) const {
    const int col = blockIdx.x * bn + c;
    return {col < N ? W + col : nullptr, N};
  }
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col < N) C[int64_t(m) * N + col] = gemm::from_f<T>(acc * scale[col]);
  }
};

inline Args<OneW, W8Map<bf16>> w8_args(const void* a, const void* w,
                                       const float* scale, void* c, int M,
                                       int N, int K, int bm, int bk, int bn,
                                       int stages, cudaStream_t stream) {
  const bool vec = gemm::aligned16(a) && K % 8 == 0 && bk % 8 == 0;
  return {static_cast<const bf16*>(a), OneW{w, N},
          W8Map<bf16>{static_cast<const int8_t*>(w), static_cast<bf16*>(c),
                      scale, N, bn},
          M, K, bm, bk, bn, stages, vec, 1, stream};
}

// Row 11's segment-major grid: column blocks [0, bq) hold the G Nkv q
// columns bn at a time, the next bkv the Nkv k columns, the last bkv the
// v columns.  Each reads its own weight (wq at stride G Nkv, wk or wv at
// Nkv) and stores into its own output, so no block straddles two
// projections, whatever Nkv and bn.  Source and map in one.
struct QkvBlocks {
  const bf16 *wq, *wk, *wv;
  bf16 *q, *k, *v;
  int nq, nkv, bn, bq, bkv;  // q and k/v columns; blocks of each
  // block x's projection (0 q, 1 k, 2 v) and its first column there
  __device__ int seg(int x, int& n0) const {
    const int s = x < bq ? 0 : x < bq + bkv ? 1 : 2;
    n0 = (s == 0 ? x : x - bq - (s - 1) * bkv) * bn;
    return s;
  }
  __device__ WBlock block(int x, int) const {
    int n0;
    const int s = seg(x, n0), cols = s == 0 ? nq : nkv;
    return {s == 0 ? wq : s == 1 ? wk : wv, cols, n0, min(bn, cols - n0)};
  }
  int blocks(int) const { return bq + 2 * bkv; }
  __device__ void store(int m, int c, float acc) const {
    int n0;
    const int s = seg(blockIdx.x, n0), cols = s == 0 ? nq : nkv;
    (s == 0 ? q : s == 1 ? k : v)[int64_t(m) * cols + n0 + c] =
        __float2bfloat16(acc);
  }
};

inline Args<QkvBlocks, QkvBlocks> qkv_args(
    const void* x, const void* wq, const void* wk, const void* wv, void* q,
    void* k, void* v, int M, int nkv, int K, int groups, int bm, int bk,
    int bn, int stages, cudaStream_t stream) {
  const bool vec = gemm::aligned16(x) && gemm::aligned16(wq) &&
                   gemm::aligned16(wk) && gemm::aligned16(wv) &&
                   K % 8 == 0 && bk % 8 == 0 && nkv % 8 == 0 && bn % 8 == 0;
  const int nq = groups * nkv;
  const QkvBlocks b{static_cast<const bf16*>(wq), static_cast<const bf16*>(wk),
                    static_cast<const bf16*>(wv), static_cast<bf16*>(q),
                    static_cast<bf16*>(k), static_cast<bf16*>(v), nq, nkv,
                    bn, ceil_div(nq, bn), ceil_div(nkv, bn)};
  return {static_cast<const bf16*>(x), b, b, M, K, bm, bk, bn, stages, vec,
          0, stream};
}

}  // namespace mma_inst
