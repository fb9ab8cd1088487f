// Direct blocked convolution for Hopper: the port of
// repro/kernels/conv2d_blocked.py::conv2d_block (pallas_call at :141, body
// _conv_kernel at :71) with its level-1 driver conv2d_tiled (:99).
//
// out[n, y, x, k] = sum_{i, j, c} x[n, y*s + i, x*s + j, c] * w[i, j, c, k],
// NHWC x HWIO -> NHWC, VALID padding, stride s, fp32 or bf16 in and out
// with fp32 sums.  The dgrad of the same conv (conv2d_bwd.conv2d_dgrad)
// runs this kernel too, at stride 1, on the dilated and padded cotangent.
//
// The paper's two-level blocking.  On the TPU the level-1 spatial tiles
// were host slices, the batch was vmapped, and the C reduction was the
// minor sequential grid axis with the accumulator in VMEM scratch.  Here
// one launch covers the batch: the grid is (spatial tile of bx x by
// outputs, K tile of bk, image), each block computes its own halo offsets
// from blockIdx and the stride, and walks the whole C reduction in a loop,
// bc channels a step, with its fp32 accumulator in registers -- the
// paper's output buffer held across C.  A step stages the haloed input
// tile (((by-1)*s + Fh) x ((bx-1)*s + Fw) pixels x bc channels) and the
// weight tile (Fh * Fw taps x bc x bk) in dynamic shared memory, two
// stages deep: the next step's tiles are copied with cp.async while the
// current ones are used (conv_tile.cuh; the bf16 instance keeps one
// stage where C takes one step, as at C = 3).  The block then runs the Fh x Fw
// window over the staged input -- the sliding-window reuse of paper
// section 4.2: each staged pixel is read by every output whose window
// covers it, and never copied into an im2col matrix.  Ragged C, K and
// image edges are zero-filled at staging and masked at the store, so
// every shape launches.
//
// Bound on this card: at the paper's Table-4 sizes the conv is bound by
// operations (Conv1 at batch 2: 1.56 TMAC over 0.3 GB, 3.153 ms at the
// 989 TFLOP/s bf16 peak).
//
// bf16: an implicit GEMM on the tensor cores inside the block.  M is the
// block's bx * by output pixels, N its bk output channels, and the
// reduction runs over (tap, channel): 8-channel chunks of the staged
// tile, tap after tap, two chunks a 16-deep k-step (mma.sync m16n8k16,
// mma_frag.cuh).  A fragments come by ldmatrix.x4 straight from the
// staged input: each lane supplies the address of its row's pixel
// (py*s + i, px*s + j) for its chunk, from a table of chunk offsets built
// once per block, so a k-step may straddle two taps (bc = 8 at Conv1's
// 11 x 11) and nothing is expanded into an im2col tile.  B fragments
// come by ldmatrix.x4.trans from the weight tile, whose rows are the
// same (tap, channel) chunks, padded with zero rows to whole k-steps.
// The 8 warps tile M x N as wm x wn warps of mt m16 tiles x nt n8 tiles
// each (mt * nt <= 16: 64 fp32 sums a thread, held across the whole C
// loop; mma_layout picks the grid); a row of M past bx * by reads the
// last pixel and is never stored, an n8 tile past bk reads clamped
// columns and is never stored.  Bank conflicts: the 8 rows of one
// ldmatrix sub-matrix must fall into distinct bank groups.  The pixel
// stride is an odd number of 16-byte vectors, which does that at odd
// strides s (at an even s neighbouring pixels are s pixel-strides apart
// and share groups: AlexNet conv1's stride 4 pays 4-way conflicts on A);
// weight rows of a power-of-two vector count are XOR-swizzled, odd counts
// need nothing, others are padded by a vector.  Staging copies only the
// vectors the fragments read, one division per staged pixel or row.  C
// below 8 (C = 3) is zero-padded to one chunk at staging.  This is
// mma.sync, not wgmma: its A and B are re-read from shared memory by
// every warp each k-step, which bounds it well below the card's peak; a
// wgmma version (64-row warpgroup tiles, B in a swizzled shared tile) is
// the next step.
//
// fp32: the CUDA-core loop.  TF32 tensor cores would round the operands
// to 10 mantissa bits and break the fp32 tolerances of the kernel checks
// and the fp32 oracles, so fp32 multiplies in fp32: 256 threads tile the
// output as thread-rows of pixels x column groups of 4 (ceil(bk/4)
// groups, 256 / groups thread-rows, each thread up to 16 pixels x 4
// columns, the pixel count a template argument); a thread reads 4
// channels of a pixel and the 4 x 4 weights they meet in vector loads, 16
// fused multiply-adds per 4 + 1 shared loads of one pixel.
#include "conv_tile.cuh"
#include "mma_frag.cuh"

namespace {

using conv::kCols;
using conv::kThreads;
constexpr int kMaxRows = 16;  // pixels per thread: 64 fp32 accumulators

// ---------------------------- fp32: CUDA cores -----------------------------

template <typename T, int RR>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd(const T* __restrict__ x, const T* __restrict__ w,
         T* __restrict__ out, int H, int W, int C, int K, int Fh, int Fw,
         int OH, int OW, int s, int bx, int by, int bc, int bk, int ntx) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const int n = blockIdx.z, k0 = blockIdx.y * bk;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int oy0 = ty * by, ox0 = tx * bx;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int pst = conv::pixel_stride<T>(bc);
  const int bc4 = conv::round_up(bc, 4), bkp = conv::round_up(bk, V);
  const int taps = Fh * Fw;
  const int in_size = ih * iw * pst;
  const int stage = in_size + taps * bc4 * bkp;  // elements of one stage
  T* const base = reinterpret_cast<T*>(smem);

  const int ncg = conv::ceil_div(bk, kCols);
  const int n_tr = kThreads / ncg;
  const int cg = threadIdx.x % ncg, tr = threadIdx.x / ncg;
  const bool active = tr < n_tr;
  const int P = bx * by, rows = conv::ceil_div(P, n_tr);
  const int col0 = cg * kCols;

  // where each of the thread's pixels starts in the staged input (a
  // pixel past the tile reads pixel 0 and is never stored)
  int pb[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int p = tr + j * n_tr;
    const int py = p / bx, px = p - py * bx;
    pb[j] = j < rows && p < P ? (py * s * iw + px * s) * pst : 0;
  }
  float acc[RR][kCols];
#pragma unroll
  for (int j = 0; j < RR; ++j)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;

  auto load = [&](int buf, int c0) {
    T* const xs = base + buf * stage;
    conv::stage_input<T>(xs, x, n, H, W, C, oy0 * s, ox0 * s, ih, iw, c0,
                         bc, pst);
    // weight row (tap, cc): w[tap, c0 + cc, k0 .. k0 + bk]
    conv::stage_rows<T>(xs + in_size, taps * bc4, bkp,
                        [=](int r, const T*& src) {
                          const int tap = r / bc4, cc = r - tap * bc4;
                          src = w + (int64_t(tap) * C + c0 + cc) * K + k0;
                          return cc < bc && c0 + cc < C ? min(bk, K - k0)
                                                        : 0;
                        });
    gemm::cp_async_commit();
  };
  const int nc = conv::ceil_div(C, bc);
  load(0, 0);
  for (int t = 0; t < nc; ++t) {
    if (t + 1 < nc) {
      load((t + 1) & 1, (t + 1) * bc);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const T* const xs = base + (t & 1) * stage;
      const T* const ws = xs + in_size + col0;
      // channels past C are zero in both tiles: stop at the last group
      // of 4 that holds one
      const int cend = min(bc4, conv::round_up(C - t * bc, 4));
      for (int i = 0; i < Fh; ++i) {
        for (int j = 0; j < Fw; ++j) {
          const T* const xt = xs + (i * iw + j) * pst;
          const T* const wt = ws + (i * Fw + j) * bc4 * bkp;
          for (int c = 0; c < cend; c += 4) {
            float wv[4][kCols];
#pragma unroll
            for (int q = 0; q < 4; ++q) gemm::load4(wt + (c + q) * bkp, wv[q]);
#pragma unroll
            for (int jj = 0; jj < RR; ++jj) {
              float xv[4];
              gemm::load4(xt + pb[jj] + c, xv);
#pragma unroll
              for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int cc = 0; cc < kCols; ++cc)
                  acc[jj][cc] = fmaf(xv[q], wv[q][cc], acc[jj][cc]);
            }
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int jj = 0; jj < RR; ++jj) {
    const int p = tr + jj * n_tr;
    if (jj >= rows || p >= P) continue;
    const int py = p / bx, px = p - py * bx;
    const int oy = oy0 + py, ox = ox0 + px;
    if (oy >= OH || ox >= OW) continue;
    T* const o = out + ((int64_t(n) * OH + oy) * OW + ox) * K + k0;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) {
      const int kk = col0 + cc;
      if (kk < bk && k0 + kk < K) o[kk] = gemm::from_f<T>(acc[jj][cc]);
    }
  }
}

template <typename T, int RR>
int launch(const T* x, const T* w, T* out, int N, int H, int W, int C,
           int K, int Fh, int Fw, int s, int bx, int by, int bc, int bk,
           cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  constexpr int V = 16 / sizeof(T);
  const int OH = (H - Fh) / s + 1, OW = (W - Fw) / s + 1;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int smem = 2 *
                   (ih * iw * conv::pixel_stride<T>(bc) +
                    Fh * Fw * conv::round_up(bc, 4) * conv::round_up(bk, V)) *
                   int(sizeof(T));
  auto kernel = conv_fwd<T, RR>;
  const int err = conv::allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const int ntx = conv::ceil_div(OW, bx), nty = conv::ceil_div(OH, by);
  const dim3 grid(ntx * nty, conv::ceil_div(K, bk), N);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, out, H, W, C, K, Fh, Fw, OH,
                                           OW, s, bx, by, bc, bk, ntx);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const void* w, void* out, int N, int H, int W,
             int C, int K, int Fh, int Fw, int s, int bx, int by, int bc,
             int bk, cudaStream_t stream) {
  const int ncg = conv::ceil_div(bk, kCols);
  if (ncg > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = conv::ceil_div(bx * by, kThreads / ncg);
  const T* X = static_cast<const T*>(x);
  const T* Wt = static_cast<const T*>(w);
  T* O = static_cast<T*>(out);
#define CONV_ROWS(RR)                                                     \
  if (rows <= RR)                                                         \
    return launch<T, RR>(X, Wt, O, N, H, W, C, K, Fh, Fw, s, bx, by, bc,  \
                         bk, stream);
  CONV_ROWS(1)
  CONV_ROWS(2)
  CONV_ROWS(4)
  CONV_ROWS(8)
  CONV_ROWS(kMaxRows)
#undef CONV_ROWS
  return static_cast<int>(cudaErrorInvalidValue);
}

// ------------------------- bf16: tensor cores ------------------------------

using bf16 = __nv_bfloat16;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrags = 16;  // m16 x n8 tiles a warp holds: 64 fp32 sums
constexpr int kMaxNt = 8;      // n8 tiles a warp holds

struct Layout {
  int wm, wn, mt, nt;  // warps down M and across N; m16 and n8 tiles each
};

// The warp grid of a (pixels x bk) output tile: the fewest warps across
// N (wn = 1, 2, 4, 8; wm = 8 / wn down M) with nt <= kMaxNt whose
// fragments fit (mt * nt <= kMaxFrags), so each A fragment feeds the most
// n8 tiles; if none fits, the fewest with nt <= kMaxNt, which the caller
// refuses.  kernels/conv2d_blocked.py::mma_layout is the same function.
inline Layout mma_layout(int pixels, int bk) {
  const int mt_all = conv::ceil_div(pixels, 16);
  const int nt_all = conv::ceil_div(bk, 8);
  Layout first{0, 0, 0, 0};
  for (int wn = 1; wn <= kWarps; wn *= 2) {
    const int wm = kWarps / wn;
    const Layout l{wm, wn, conv::ceil_div(mt_all, wm),
                   conv::ceil_div(nt_all, wn)};
    if (l.nt > kMaxNt) continue;
    if (l.mt * l.nt <= kMaxFrags) return l;
    if (first.wm == 0) first = l;
  }
  return first;
}

// weight-tile rows: Fh * Fw taps of bc channels rounded up to 8-channel
// chunks, the chunks rounded up to whole 16-deep k-steps
__host__ __device__ inline int weight_rows(int taps, int bc) {
  return conv::round_up(taps * conv::round_up(bc, 8), 16);
}

// weight rows: 16-byte vectors and swizzle as conv_tile.cuh's staged
// tensor-core rows
using conv::row_swizzle;
using conv::row_vectors;
using conv::Swizzle;

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
conv_fwd_mma(const bf16* __restrict__ x, const bf16* __restrict__ w,
             bf16* __restrict__ out, int H, int W, int C, int K, int Fh,
             int Fw, int OH, int OW, int s, int bx, int by, int bc, int bk,
             int ntx, int wn_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.z, k0 = blockIdx.y * bk;
  const int ty = blockIdx.x / ntx, tx = blockIdx.x - ty * ntx;
  const int oy0 = ty * by, ox0 = tx * bx;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int pst = conv::pixel_stride<bf16>(bc);
  const int bcp = conv::round_up(bc, 8), nch = bcp / 8;
  const int wvs = row_vectors(bk);                // vectors a weight row
  const int wv = conv::ceil_div(bk, 8);           // of them staged
  const Swizzle sw = row_swizzle(wvs);
  const int taps = Fh * Fw, rows = weight_rows(taps, bc);
  const int in_size = ih * iw * pst;
  const int stage = in_size + rows * wvs * 8;  // elements of one stage
  const int nc = conv::ceil_div(C, bc);         // C steps: one stage if 1
  bf16* const base = reinterpret_cast<bf16*>(smem);
  int* const chunk_off =
      reinterpret_cast<int*>(base + (nc > 1 ? 2 : 1) * stage);

  // byte offset in the staged input of reduction chunk q (tap, 8
  // channels) from a pixel's window origin; the pad chunk of an odd
  // count meets zero weight rows
  for (int q = threadIdx.x; q < rows / 8; q += kThreads) {
    int off = 0;
    if (q < taps * nch) {
      const int tap = q / nch, i = tap / Fw, j = tap - i * Fw;
      off = ((i * iw + j) * pst + (q - tap * nch) * 8) * 2;
    }
    chunk_off[q] = off;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;
  const int P = bx * by;
  const int row16 = lane & 15, half = lane >> 4;
  // A: the window origin of this lane's row of each m16 tile (a row past
  // the tile reads the last pixel and is never stored)
  uint32_t a_off[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int p = min((wm * MT + mt) * 16 + row16, P - 1);
    const int py = p / bx, px = p - py * bx;
    a_off[mt] = (py * s * iw + px * s) * pst * 2;
  }
  // B: the logical vector (within a k-step) of this lane's k-row and
  // column for each pair of n8 tiles (a column past bk is clamped into
  // the staged ones and never stored)
  constexpr int NP = (NT + 1) / 2;
  int b_vec[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j)
    b_vec[j] = row16 * wvs + min(wn * NT + 2 * j + half, wv - 1);
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // a thread stages one vector column of every (256 / wv)-th weight row
  const int wcols = min(wv, kThreads), wstep = kThreads / wcols;
  const bool stager = threadIdx.x < wstep * wcols;
  auto load = [&](int buf, int c0) {
    bf16* const xs = base + buf * stage;
    conv::stage_input<bf16>(xs, x, n, H, W, C, oy0 * s, ox0 * s, ih, iw, c0,
                            bc, pst, nch);
    // weight row (tap, cc): w[tap, c0 + cc, k0 .. k0 + bk]; rows past
    // the last tap and channels past bc or C are zero (they meet real
    // pixels); columns past bk are never read unclamped and not staged
    bf16* const ws = xs + in_size;
    for (int r = threadIdx.x / wcols; stager && r < rows; r += wstep) {
      const int tap = r / bcp, cc = r - tap * bcp;
      const bool in = tap < taps && cc < bc && c0 + cc < C;
      const bf16* const src = w + (int64_t(tap) * C + c0 + cc) * K + k0;
      for (int c = threadIdx.x % wcols; c < wv; c += wcols) {
        const int L = r * wvs + c;
        conv::stage_vec(ws + (L ^ ((L >> sw.shift) & sw.mask)) * 8,
                        src + c * 8, in ? min(bk, K - k0) - c * 8 : 0);
      }
    }
    gemm::cp_async_commit();
  };
  const int ksteps = rows / 16;
  const uint32_t s0 = mma::smem_addr(base);
  load(0, 0);
  for (int t = 0; t < nc; ++t) {
    if (t + 1 < nc) {
      load((t + 1) & 1, (t + 1) * bc);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t xs = s0 + (t & 1) * stage * 2;
    const uint32_t ws = xs + in_size * 2;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t xk = xs + chunk_off[2 * ks + half];
      uint32_t b[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int L = ks * 16 * wvs + b_vec[j];
        mma::ldmatrix_x4_trans(
            b[j], ws + (L ^ ((L >> sw.shift) & sw.mask)) * 16);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        mma::ldmatrix_x4(a, xk + a_off[mt]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma::mma_bf16_16816(acc[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                              b[nt / 2][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();
  }

  // c[0..1]: row g, columns 2t, 2t + 1; c[2..3]: row g + 8
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool pairs = ((K | bk) & 1) == 0;  // (kk, kk + 1) 4-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int p = (wm * MT + mt) * 16 + g + hr * 8;
      if (p >= P) continue;
      const int py = p / bx, px = p - py * bx;
      const int oy = oy0 + py, ox = ox0 + px;
      if (oy >= OH || ox >= OW) continue;
      bf16* const o = out + ((int64_t(n) * OH + oy) * OW + ox) * K + k0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int kk = (wn * NT + nt) * 8 + c2;
        const float v0 = acc[mt][nt][hr * 2], v1 = acc[mt][nt][hr * 2 + 1];
        if (pairs && kk + 1 < bk && k0 + kk + 1 < K) {
          *reinterpret_cast<__nv_bfloat162*>(o + kk) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (kk < bk && k0 + kk < K) o[kk] = __float2bfloat16(v0);
          if (kk + 1 < bk && k0 + kk + 1 < K) o[kk + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

// dynamic shared memory of the bf16 kernel: two stages of the input and
// weight tiles (one where C takes one step), then the chunk-offset table
inline int mma_smem_bytes(int bx, int by, int Fh, int Fw, int s, int C,
                          int bc, int bk) {
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int rows = weight_rows(Fh * Fw, bc);
  return (C > bc ? 2 : 1) *
             (ih * iw * conv::pixel_stride<bf16>(bc) +
              rows * row_vectors(bk) * 8) *
             int(sizeof(bf16)) +
         rows / 8 * int(sizeof(int));
}

struct MmaArgs {
  const bf16* x;
  const bf16* w;
  bf16* out;
  int N, H, W, C, K, Fh, Fw, s, bx, by, bc, bk;
  cudaStream_t stream;
};

template <int MT, int NT>
int launch_mma(const MmaArgs& a, int wn) {
  static int smem_set = 48 * 1024;
  const int OH = (a.H - a.Fh) / a.s + 1, OW = (a.W - a.Fw) / a.s + 1;
  const int smem =
      mma_smem_bytes(a.bx, a.by, a.Fh, a.Fw, a.s, a.C, a.bc, a.bk);
  auto kernel = conv_fwd_mma<MT, NT>;
  const int err = conv::allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const int ntx = conv::ceil_div(OW, a.bx), nty = conv::ceil_div(OH, a.by);
  const dim3 grid(ntx * nty, conv::ceil_div(a.K, a.bk), a.N);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.x, a.w, a.out, a.H, a.W, a.C, a.K, a.Fh, a.Fw, OH, OW, a.s, a.bx,
      a.by, a.bc, a.bk, ntx, wn);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the layout's (mt, nt): every pair with mt * nt <=
// kMaxFrags and nt <= kMaxNt is compiled
template <int MT = 1, int NT = 1>
int dispatch_mma(const MmaArgs& a, const Layout& l) {
  if constexpr (MT * NT <= kMaxFrags) {
    if (l.mt == MT && l.nt == NT) return launch_mma<MT, NT>(a, l.wn);
  }
  if constexpr (NT < kMaxNt)
    return dispatch_mma<MT, NT + 1>(a, l);
  else if constexpr (MT < kMaxFrags)
    return dispatch_mma<MT + 1, 1>(a, l);
  else
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out (N, OH, OW, K) = conv(x (N, H, W, C), w (Fh, Fw, C, K)), VALID,
// stride s, spatial tiles bx x by, channel tiles bc and bk.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int conv2d_blocked_fwd(int dtype, const void* x, const void* w,
                                  void* out, int N, int H, int W, int C,
                                  int K, int Fh, int Fw, int s, int bx,
                                  int by, int bc, int bk, void* stream) {
  if (N <= 0 || C <= 0 || K <= 0 || Fh <= 0 || Fw <= 0 || s <= 0 ||
      H < Fh || W < Fw || bx <= 0 || by <= 0 || bc <= 0 || bk <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w, out, N, H, W, C, K, Fh, Fw, s, bx, by, bc,
                           bk, st);
  if (dtype == 1) {
    const Layout l = mma_layout(bx * by, bk);
    if (l.wm == 0 || l.mt * l.nt > kMaxFrags)
      return static_cast<int>(cudaErrorInvalidValue);
    const MmaArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
                    static_cast<bf16*>(out), N, H, W, C, K, Fh, Fw, s, bx,
                    by, bc, bk, st};
    return dispatch_mma(a, l);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
