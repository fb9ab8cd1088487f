// Weight gradient of the direct convolution for Hopper: the port of
// repro/kernels/conv2d_bwd.py::conv2d_wgrad_block (pallas_call at :107,
// body _wgrad_kernel at :75) with its driver conv2d_wgrad (:122).
//
// dW[i, j, c, k] = sum_{n, y, x} X[n, y*s + i, x*s + j, c] * g[n, y, x, k],
// fp32, for y = conv2d(X, W, stride s); X (N, H, W, C) and g (N, OH, OW, K)
// in fp32 or bf16.  The same (Fw, Fh, X, Y, C, K) nest as the forward with
// the weights written and the output space reduced.
//
// On the TPU one fp32 partial per (image, spatial tile) was written and
// the partials summed on the host in a scan.  Hopper's blocks run in no
// order and carry nothing between them, and a block per (C tile, K tile)
// alone would give Conv4 a few dozen blocks for 132 SMs.  So two passes,
// with no atomics:
//
// 1. wgrad_partial (fp32) / wgrad_mma (bf16): blocks over (C tile of bc x
//    K tile of bk, split).  Split s reduces a fixed, contiguous range of
//    the N * (spatial tiles) (image, tile) pairs, in order, into an fp32
//    partial (Fh, Fw, bc, bk) held in registers -- the paper's output
//    buffer, resident while the whole range streams through.  Per pair it
//    stages the haloed input tile (((by-1)*s + Fh) x ((bx-1)*s + Fw)
//    pixels x bc channels) and the cotangent tile (by x bx pixels x bk),
//    two stages deep with cp.async (conv_tile.cuh), and every staged input
//    pixel meets the Fh * Fw taps that read it.
// 2. wgrad_sum: dW[e] = sum over splits of partial[split, e], in split
//    order.  The split count comes from the grid (enough blocks to fill
//    the card), so for one card and one shape the result is bit-equal from
//    launch to launch.
//
// Bound on this card: at the Table-4 sizes the wgrad does the forward's
// operations and is bound by them (Conv1 at batch 2: 1.56 TMAC, 3.153 ms
// at the 989 TFLOP/s bf16 peak).  Both designs keep the dW tile in
// registers across the whole reduction, so HBM sees each pair's tiles once
// per (C, K) tile and the partials once.
//
// bf16: an implicit GEMM on the tensor cores inside the block.  M is the
// dW tile's rows in (tap, channel) order: Fh * Fw taps of bc channels
// rounded up to 8-channel chunks, so at 11 x 11 with bc = 8 one m16
// fragment spans two taps.  N is the bk output channels.  The reduction
// runs over the pair's bx * by output pixels, rounded up to whole 16-deep
// k-steps (mma.sync m16n8k16, mma_frag.cuh).  A is the staged input read
// transposed: an 8 x 8 sub-matrix is 8 pixel rows of one 8-channel chunk,
// and ldmatrix.x4.trans delivers it as the (channel, pixel) fragment.
// Each lane supplies the address of its pixel (py*s + i, px*s + j) for its
// chunk: a per-block table of the staged pixels' offsets (the spatial
// tile is fixed per block; only the stage buffer changes) plus the lane's
// (tap, chunk) offset, held in registers, so no k-step divides.  B is the
// staged cotangent tile, pixel rows of bk contiguous columns, read with
// ldmatrix.x4.trans as row 12's weight tile is.  The reduction is not
// masked at the store (every pixel adds into every sum), so a pixel past
// the tile or past OH / OW stages an exact-zero cotangent row, and its A
// rows point at staged, finite data (the last real pixel): shared memory
// is not initialised and 0 x NaN = NaN.  M rows past the dW tile (the
// pad chunk of an odd count, channels past bc or C: C = 3 is zero-padded
// to one chunk at staging) are computed and never stored, as are n8
// tiles past bk (clamped into the staged columns).  The 8 warps tile M x
// N as wm x wn warps of mt m16 x nt n8 fragments (mt * nt <= 16: 64 fp32
// sums a thread; mma_layout picks the grid).  Bank conflicts: the 8 rows
// of an A sub-matrix are 8 consecutive pixels, an odd number of 16-byte
// vectors apart at odd strides (pixel_stride); at an even stride they
// share bank groups (AlexNet conv1's stride 4: 4-way), and a sub-matrix
// that wraps a tile row (bx not a multiple of 8) may pair two.  Cotangent
// rows use the weight tile's vector count and XOR swizzle (row_vectors).
//
// fp32: the CUDA-core loop.  TF32 tensor cores would round the operands
// to 10 mantissa bits and break the fp32 tolerances (conv2d_blocked.cu).
// 256 threads: ceil(bk/4) column groups of 4 k by 256 / groups
// thread-rows; a thread-row holds up to 4 groups of (tap, 4 channels), 16
// sums each (64 at most), and per output pixel reads 4 cotangent values
// and each group's 4 input channels in vector loads: 16 fused
// multiply-adds per load.
#include "conv_tile.cuh"
#include "mma_frag.cuh"

namespace {

using conv::kCols;
using conv::kThreads;
constexpr int kMaxRows = 4;  // (tap, 4-channel) groups per thread: 64 sums

template <typename T, int RR>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_partial(const T* __restrict__ x, const T* __restrict__ g,
              float* __restrict__ part, int N, int H, int W, int C, int K,
              int Fh, int Fw, int OH, int OW, int s, int bx, int by, int bc,
              int bk, int ntx, int nty, int splits) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const int nkt = conv::ceil_div(K, bk);
  const int ct = blockIdx.x / nkt, kt = blockIdx.x - ct * nkt;
  const int split = blockIdx.y;
  const int c0 = ct * bc, k0 = kt * bk;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int pst = conv::pixel_stride<T>(bc);
  const int bkp = conv::round_up(bk, V), nc4 = conv::ceil_div(bc, 4);
  const int taps = Fh * Fw;
  const int in_size = ih * iw * pst;
  const int stage = in_size + bx * by * bkp;  // elements of one stage
  T* const base = reinterpret_cast<T*>(smem);

  const int ncg = conv::ceil_div(bk, kCols);
  const int n_tr = kThreads / ncg;
  const int cg = threadIdx.x % ncg, tr = threadIdx.x / ncg;
  const bool active = tr < n_tr;
  const int groups = taps * nc4, rows = conv::ceil_div(groups, n_tr);
  const int col0 = cg * kCols;

  // where each of the thread's (tap, 4-channel) groups starts in the
  // staged input, for output pixel 0 (a group past the last reads
  // group 0 and is never stored)
  int rb[RR];
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    const int tap = r / nc4, c4 = r - tap * nc4;
    const int i = tap / Fw, jj = tap - i * Fw;
    rb[j] = j < rows && r < groups ? (i * iw + jj) * pst + c4 * 4 : 0;
  }
  float acc[RR][4][kCols];
#pragma unroll
  for (int j = 0; j < RR; ++j)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < kCols; ++b) acc[j][a][b] = 0.f;

  const int nsp = ntx * nty;
  const int64_t pairs = int64_t(N) * nsp;
  const int64_t q0 = pairs * split / splits, q1 = pairs * (split + 1) / splits;
  auto load = [&](int buf, int64_t q) {
    const int n = int(q / nsp), t = int(q - int64_t(n) * nsp);
    const int ty = t / ntx, tx = t - ty * ntx;
    T* const xs = base + buf * stage;
    conv::stage_input<T>(xs, x, n, H, W, C, ty * by * s, tx * bx * s, ih, iw,
                         c0, bc, pst);
    // cotangent row p: g[n, ty*by + p / bx, tx*bx + p % bx, k0 .. k0 + bk]
    conv::stage_rows<T>(xs + in_size, bx * by, bkp,
                        [=](int p, const T*& src) {
                          const int oy = ty * by + p / bx;
                          const int ox = tx * bx + p % bx;
                          src = g + ((int64_t(n) * OH + oy) * OW + ox) * K +
                                k0;
                          return oy < OH && ox < OW ? min(bk, K - k0) : 0;
                        });
    gemm::cp_async_commit();
  };
  if (q0 < q1) load(0, q0);
  for (int64_t q = q0; q < q1; ++q) {
    const int buf = int(q - q0) & 1;
    if (q + 1 < q1) {
      load(buf ^ 1, q + 1);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int t = int(q % nsp);
      const int ty = t / ntx, tx = t - ty * ntx;
      // output pixels past the image carry a zero cotangent: skip them
      const int ny = min(by, OH - ty * by), nx = min(bx, OW - tx * bx);
      const T* const xs = base + buf * stage;
      const T* const gs = xs + in_size + col0;
      for (int py = 0; py < ny; ++py) {
        for (int px = 0; px < nx; ++px) {
          const int poff = (py * s * iw + px * s) * pst;
          float gv[kCols];
          gemm::load4(gs + (py * bx + px) * bkp, gv);
#pragma unroll
          for (int j = 0; j < RR; ++j) {
            float xv[4];
            gemm::load4(xs + rb[j] + poff, xv);
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
              for (int b = 0; b < kCols; ++b)
                acc[j][a][b] = fmaf(xv[a], gv[b], acc[j][a][b]);
          }
        }
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < RR; ++j) {
    const int r = tr + j * n_tr;
    if (j >= rows || r >= groups) continue;
    const int tap = r / nc4, c4 = r - tap * nc4;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int cc = c4 * 4 + a;
      if (cc >= bc || c0 + cc >= C) continue;
      float* const o =
          part + ((int64_t(split) * taps + tap) * C + c0 + cc) * K + k0;
#pragma unroll
      for (int b = 0; b < kCols; ++b) {
        const int kk = col0 + b;
        if (kk < bk && k0 + kk < K) o[kk] = acc[j][a][b];
      }
    }
  }
}

// dW[e] = partial[0, e] + partial[1, e] + ... in split order
__global__ void wgrad_sum(const float* __restrict__ part,
                          float* __restrict__ out, int64_t E, int splits) {
  for (int64_t e = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; e < E;
       e += int64_t(gridDim.x) * blockDim.x) {
    float v = part[e];
    for (int sp = 1; sp < splits; ++sp) v += part[sp * E + e];
    out[e] = v;
  }
}

// the second pass over the (Fh, Fw, C, K) partials
int sum_partials(const float* part, float* out, int Fh, int Fw, int C, int K,
                 int splits, cudaStream_t stream) {
  const int64_t E = int64_t(Fh) * Fw * C * K;
  const int64_t blocks = (E + kThreads - 1) / kThreads;
  wgrad_sum<<<int(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      part, out, E, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RR>
int launch(const T* x, const T* g, float* part, float* out, int N, int H,
           int W, int C, int K, int Fh, int Fw, int s, int bx, int by,
           int bc, int bk, int splits, cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  constexpr int V = 16 / sizeof(T);
  const int OH = (H - Fh) / s + 1, OW = (W - Fw) / s + 1;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int smem = 2 *
                   (ih * iw * conv::pixel_stride<T>(bc) +
                    bx * by * conv::round_up(bk, V)) *
                   int(sizeof(T));
  auto kernel = wgrad_partial<T, RR>;
  int err = conv::allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const int ntx = conv::ceil_div(OW, bx), nty = conv::ceil_div(OH, by);
  const dim3 grid(conv::ceil_div(C, bc) * conv::ceil_div(K, bk), splits);
  kernel<<<grid, kThreads, smem, stream>>>(x, g, part, N, H, W, C, K, Fh, Fw,
                                           OH, OW, s, bx, by, bc, bk, ntx,
                                           nty, splits);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(part, out, Fh, Fw, C, K, splits, stream);
}

template <typename T>
int dispatch(const void* x, const void* g, float* part, float* out, int N,
             int H, int W, int C, int K, int Fh, int Fw, int s, int bx,
             int by, int bc, int bk, int splits, cudaStream_t stream) {
  const int ncg = conv::ceil_div(bk, kCols);
  if (ncg > kThreads) return static_cast<int>(cudaErrorInvalidValue);
  const int rows =
      conv::ceil_div(Fh * Fw * conv::ceil_div(bc, 4), kThreads / ncg);
  const T* X = static_cast<const T*>(x);
  const T* G = static_cast<const T*>(g);
#define WGRAD_ROWS(RR)                                                    \
  if (rows <= RR)                                                         \
    return launch<T, RR>(X, G, part, out, N, H, W, C, K, Fh, Fw, s, bx, by, \
                         bc, bk, splits, stream);
  WGRAD_ROWS(1)
  WGRAD_ROWS(2)
  WGRAD_ROWS(kMaxRows)
#undef WGRAD_ROWS
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

// The warp grid of a dW tile of `rows` (tap, channel) rows x bk columns:
// of the grids wn = 1, 2, 4, 8 (wm = 8 / wn; wn at most the n8 tiles, or
// a warp would only repeat clamped columns) with nt <= kMaxNt whose
// fragments fit (mt * nt <= kMaxFrags), the one that leaves at most 1/8
// of its computed rows empty (MAX_EMPTY_ROWS), then needs the fewest
// ldmatrix.x4 a k-step (mt + ceil(nt / 2)), then computes the fewest
// fragments, then has the fewest warps across N; if none fits, the first
// with nt <= kMaxNt, which the caller refuses.
// kernels/conv2d_bwd.py::mma_layout is the same function.
inline Layout mma_layout(int rows, int bk) {
  const int mt_all = conv::ceil_div(rows, 16);
  const int nt_all = conv::ceil_div(bk, 8);
  Layout first{0, 0, 0, 0}, best{0, 0, 0, 0};
  int best_key = 0;
  for (int wn = 1; wn <= kWarps && (wn == 1 || wn <= nt_all); wn *= 2) {
    const int wm = kWarps / wn;
    const Layout l{wm, wn, conv::ceil_div(mt_all, wm),
                   conv::ceil_div(nt_all, wn)};
    if (l.nt > kMaxNt) continue;
    if (first.wm == 0) first = l;
    if (l.mt * l.nt > kMaxFrags) continue;
    const int computed = 16 * wm * l.mt;
    // (sparse, loads, fragments) in order: loads <= 24, fragments <= 16
    const int key = (8 * (computed - rows) > computed ? 1 << 16 : 0) +
                    ((l.mt + (l.nt + 1) / 2) << 8) + l.mt * l.nt;
    if (best.wm == 0 || key < best_key) {
      best = l;
      best_key = key;
    }
  }
  return best.wm ? best : first;
}

// k-steps the main loop unrolls: two, but one where two steps' fragments
// would spill at 128 registers (ptxas -v on the H100 machine: more than 8
// m16 tiles, or an odd n8 count over 12 fragments; one step everywhere
// cost Conv1 about 1%)
template <int MT, int NT>
constexpr int kUnrollOf = MT > 8 || (NT % 2 == 1 && MT * NT > 12) ? 1 : 2;

template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
wgrad_mma(const bf16* __restrict__ x, const bf16* __restrict__ g,
          float* __restrict__ part, int N, int H, int W, int C, int K,
          int Fh, int Fw, int OH, int OW, int s, int bx, int by, int bc,
          int bk, int ntx, int nty, int splits, int wn_count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nkt = conv::ceil_div(K, bk);
  const int ct = blockIdx.x / nkt, kt = blockIdx.x - ct * nkt;
  const int split = blockIdx.y;
  const int c0 = ct * bc, k0 = kt * bk;
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int pst = conv::pixel_stride<bf16>(bc);
  const int bcp = conv::round_up(bc, 8), nch = bcp / 8;
  const int taps = Fh * Fw, rows = taps * bcp;
  const int P = bx * by, P16 = conv::round_up(P, 16);
  const int gvs = conv::row_vectors(bk);      // vectors a cotangent row
  const int gv = conv::ceil_div(bk, 8);       // of them staged
  const conv::Swizzle sw = conv::row_swizzle(gvs);
  const int in_size = ih * iw * pst;
  const int stage = in_size + P16 * gvs * 8;  // elements of one stage
  bf16* const base = reinterpret_cast<bf16*>(smem);
  int* const pix_off = reinterpret_cast<int*>(base + 2 * stage);

  // byte offset in the staged input of each pixel's window origin; the
  // pixels that pad the tile to whole k-steps read the last one (finite
  // data against their zero cotangent rows)
  for (int p = threadIdx.x; p < P16; p += kThreads) {
    const int q = min(p, P - 1), py = q / bx, px = q - py * bx;
    pix_off[p] = (py * s * iw + px * s) * pst * 2;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / wn_count, wn = warp - wm * wn_count;
  // A (ldmatrix.x4.trans): lanes 0-7 address pixels 0-7 of the k-step at
  // the m16 tile's first chunk, 8-15 the same pixels at its second chunk,
  // 16-31 pixels 8-15 likewise; a chunk past the dW tile reads chunk 0
  // and is never stored
  // (offsets in 16-byte units, two to a register: under 2^16 in any
  // tile that fits, and at 16 m16 tiles a warp the registers are short)
  const int a_pix = (lane & 7) + ((lane >> 4) << 3);
  constexpr int MP = (MT + 1) / 2;
  uint32_t a_off[MP];
#pragma unroll
  for (int j = 0; j < MP; ++j) a_off[j] = 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int q = (wm * MT + mt) * 2 + ((lane >> 3) & 1);
    uint32_t off = 0;
    if (q < taps * nch) {
      const int tap = q / nch, i = tap / Fw, j = tap - i * Fw;
      off = (i * iw + j) * (pst / 8) + (q - tap * nch);
    }
    a_off[mt / 2] |= off << (16 * (mt & 1));
  }
  // B: the logical vector (within a k-step) of this lane's pixel row and
  // column for each pair of n8 tiles (a column past bk is clamped into
  // the staged ones and never stored)
  constexpr int NP = (NT + 1) / 2;
  int b_vec[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j)
    b_vec[j] = (lane & 15) * gvs + min(wn * NT + 2 * j + (lane >> 4), gv - 1);
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // a thread stages one vector column of every (256 / gv)-th cotangent row
  const int gcols = min(gv, kThreads), gstep = kThreads / gcols;
  const bool stager = threadIdx.x < gstep * gcols;
  const int kn = min(bk, K - k0);
  const int nsp = ntx * nty;
  const int64_t pairs = int64_t(N) * nsp;
  const int64_t q0 = pairs * split / splits, q1 = pairs * (split + 1) / splits;
  auto load = [&](int buf, int64_t q) {
    const int n = int(q / nsp), t = int(q - int64_t(n) * nsp);
    const int ty = t / ntx, tx = t - ty * ntx;
    bf16* const xs = base + buf * stage;
    conv::stage_input<bf16>(xs, x, n, H, W, C, ty * by * s, tx * bx * s, ih,
                            iw, c0, bc, pst, nch);
    // cotangent row p: g[n, ty*by + p / bx, tx*bx + p % bx, k0 .. k0 + bk];
    // rows past the tile or the image, and columns past bk or K, are zero
    bf16* const gs = xs + in_size;
    for (int p = threadIdx.x / gcols; stager && p < P16; p += gstep) {
      const int py = p / bx, px = p - py * bx;
      const int oy = ty * by + py, ox = tx * bx + px;
      const bool in = p < P && oy < OH && ox < OW;
      const bf16* const src = g + ((int64_t(n) * OH + oy) * OW + ox) * K + k0;
      for (int c = threadIdx.x % gcols; c < gv; c += gcols) {
        const int L = p * gvs + c;
        conv::stage_vec(gs + (L ^ ((L >> sw.shift) & sw.mask)) * 8,
                        src + c * 8, in ? kn - c * 8 : 0);
      }
    }
    gemm::cp_async_commit();
  };
  const int ksteps = P16 / 16;
  const uint32_t s0 = mma::smem_addr(base);
  if (q0 < q1) load(0, q0);
  for (int64_t q = q0; q < q1; ++q) {
    const int buf = int(q - q0) & 1;
    if (q + 1 < q1) {
      load(buf ^ 1, q + 1);
      gemm::cp_async_wait<1>();
    } else {
      gemm::cp_async_wait<0>();
    }
    __syncthreads();
    const uint32_t xs = s0 + buf * stage * 2;
    const uint32_t gs = xs + in_size * 2;
#pragma unroll(kUnrollOf<MT, NT>)
    for (int ks = 0; ks < ksteps; ++ks) {
      const uint32_t xk = xs + pix_off[ks * 16 + a_pix];
      uint32_t b[NP][4];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        const int L = ks * 16 * gvs + b_vec[j];
        const uint32_t addr = gs + (L ^ ((L >> sw.shift) & sw.mask)) * 16;
        if (2 * j + 1 < NT)
          mma::ldmatrix_x4_trans(b[j], addr);
        else  // an odd count's last n8 tile
          mma::ldmatrix_x2_trans(b[j][0], b[j][1], addr);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        uint32_t a[4];
        mma::ldmatrix_x4_trans(
            a, xk + (((a_off[mt / 2] >> (16 * (mt & 1))) & 0xffff) << 4));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma::mma_bf16_16816(acc[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                              b[nt / 2][(nt & 1) * 2 + 1]);
      }
    }
    __syncthreads();
  }

  // c[0..1]: row r, columns 2t, 2t + 1; c[2..3]: row r + 8
  const int r0 = lane >> 2, c2 = (lane & 3) * 2;
  const bool pairs_ok = ((K | bk) & 1) == 0;  // (kk, kk + 1) 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (wm * MT + mt) * 16 + r0 + hr * 8;
      if (r >= rows) continue;
      const int tap = r / bcp, cc = r - tap * bcp;
      if (cc >= bc || c0 + cc >= C) continue;
      float* const o =
          part + ((int64_t(split) * taps + tap) * C + c0 + cc) * K + k0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int kk = (wn * NT + nt) * 8 + c2;
        const float v0 = acc[mt][nt][hr * 2], v1 = acc[mt][nt][hr * 2 + 1];
        if (pairs_ok && kk + 1 < kn) {
          *reinterpret_cast<float2*>(o + kk) = make_float2(v0, v1);
        } else {
          if (kk < kn) o[kk] = v0;
          if (kk + 1 < kn) o[kk + 1] = v1;
        }
      }
    }
  }
}

// dynamic shared memory of the bf16 kernel: two stages of the input and
// cotangent tiles, then the pixel-offset table
inline int mma_smem_bytes(int bx, int by, int Fh, int Fw, int s, int bc,
                          int bk) {
  const int ih = (by - 1) * s + Fh, iw = (bx - 1) * s + Fw;
  const int P16 = conv::round_up(bx * by, 16);
  return 2 *
             (ih * iw * conv::pixel_stride<bf16>(bc) +
              P16 * conv::row_vectors(bk) * 8) *
             int(sizeof(bf16)) +
         P16 * int(sizeof(int));
}

struct MmaArgs {
  const bf16* x;
  const bf16* g;
  float* part;
  float* out;
  int N, H, W, C, K, Fh, Fw, s, bx, by, bc, bk, splits;
  cudaStream_t stream;
};

template <int MT, int NT>
int launch_mma(const MmaArgs& a, int wn) {
  static int smem_set = 48 * 1024;
  const int OH = (a.H - a.Fh) / a.s + 1, OW = (a.W - a.Fw) / a.s + 1;
  const int smem = mma_smem_bytes(a.bx, a.by, a.Fh, a.Fw, a.s, a.bc, a.bk);
  auto kernel = wgrad_mma<MT, NT>;
  int err = conv::allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const int ntx = conv::ceil_div(OW, a.bx), nty = conv::ceil_div(OH, a.by);
  const dim3 grid(conv::ceil_div(a.C, a.bc) * conv::ceil_div(a.K, a.bk),
                  a.splits);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      a.x, a.g, a.part, a.N, a.H, a.W, a.C, a.K, a.Fh, a.Fw, OH, OW, a.s,
      a.bx, a.by, a.bc, a.bk, ntx, nty, a.splits, wn);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_partials(a.part, a.out, a.Fh, a.Fw, a.C, a.K, a.splits,
                      a.stream);
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

// dW (Fh, Fw, C, K) fp32 of y = conv(x (N, H, W, C), w, stride s) at the
// cotangent g (N, OH, OW, K): pass 1 writes `splits` partials into part
// (splits x Fh x Fw x C x K fp32), pass 2 sums them into out.  Spatial
// reduction tiles bx x by, channel tiles bc and bk.
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores).  Returns
// a cudaError_t.
extern "C" int conv2d_wgrad(int dtype, const void* x, const void* g,
                            void* part, void* out, int N, int H, int W, int C,
                            int K, int Fh, int Fw, int s, int bx, int by,
                            int bc, int bk, int splits, void* stream) {
  if (N <= 0 || C <= 0 || K <= 0 || Fh <= 0 || Fw <= 0 || s <= 0 ||
      H < Fh || W < Fw || bx <= 0 || by <= 0 || bc <= 0 || bk <= 0 ||
      splits <= 0 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* P = static_cast<float*>(part);
  float* O = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch<float>(x, g, P, O, N, H, W, C, K, Fh, Fw, s, bx, by, bc,
                           bk, splits, st);
  if (dtype == 1) {
    const Layout l = mma_layout(Fh * Fw * conv::round_up(bc, 8), bk);
    if (l.wm == 0 || l.mt * l.nt > kMaxFrags)
      return static_cast<int>(cudaErrorInvalidValue);
    const MmaArgs a{static_cast<const bf16*>(x), static_cast<const bf16*>(g),
                    P, O, N, H, W, C, K, Fh, Fw, s, bx, by, bc, bk, splits,
                    st};
    return dispatch_mma(a, l);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
