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
// 1. wgrad_partial: blocks over (C tile of bc x K tile of bk, split).
//    Split s reduces a fixed, contiguous range of the N * (spatial tiles)
//    (image, tile) pairs, in order, into an fp32 partial (Fh, Fw, bc, bk)
//    held in registers -- the paper's output buffer, resident while the
//    whole range streams through.  Per pair it stages the haloed input
//    tile (((by-1)*s + Fh) x ((bx-1)*s + Fw) pixels x bc channels) and
//    the cotangent tile (by x bx pixels x bk), two stages deep with
//    cp.async (conv_tile.cuh), and every staged input pixel meets the
//    Fh * Fw taps that read it.  256 threads: ceil(bk/4) column groups of
//    4 k by 256 / groups thread-rows; a thread-row holds up to 4 groups of
//    (tap, 4 channels), 16 sums each (64 at most), and per output pixel
//    reads 4 cotangent values and each group's 4 input channels in vector
//    loads: 16 fused multiply-adds per load.  Fh * Fw * bc * bk sums over
//    the block cap the tile hard: at 11 x 11, bc * bk <= 128.
// 2. wgrad_sum: dW[e] = sum over splits of partial[split, e], in split
//    order.  The split count comes from the grid (enough blocks to fill
//    the card), so for one card and one shape the result is bit-equal from
//    launch to launch.
//
// Bound on this card: at the Table-4 sizes the wgrad does the forward's
// operations and is bound by them (Conv1 at batch 2: 1.56 TMAC).  This
// first kernel multiplies on CUDA cores in fp32; its design keeps the dW
// tile in registers across the whole reduction, so HBM sees each pair's
// tiles once per (C, K) tile and the partials once.
#include "conv_tile.cuh"

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
  const int64_t E = int64_t(Fh) * Fw * C * K;
  const int64_t blocks = (E + kThreads - 1) / kThreads;
  wgrad_sum<<<int(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
      part, out, E, splits);
  return static_cast<int>(cudaGetLastError());
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

}  // namespace

// dW (Fh, Fw, C, K) fp32 of y = conv(x (N, H, W, C), w, stride s) at the
// cotangent g (N, OH, OW, K): pass 1 writes `splits` partials into part
// (splits x Fh x Fw x C x K fp32), pass 2 sums them into out.  Spatial
// reduction tiles bx x by, channel tiles bc and bk.
// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
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
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, g, P, O, N, H, W, C, K, Fh, Fw, s, bx,
                                   by, bc, bk, splits, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
