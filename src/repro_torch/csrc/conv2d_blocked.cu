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
// current ones are used (conv_tile.cuh).  The block then runs the Fh x Fw
// window over the staged input -- the sliding-window reuse of paper
// section 4.2: each staged pixel is read by every output whose window
// covers it, and never copied into an im2col matrix.  256 threads tile the
// output as thread-rows of pixels x column groups of 4 (ceil(bk/4) groups,
// 256 / groups thread-rows, each thread up to 16 pixels x 4 columns, the
// pixel count a template argument); a thread reads 4 channels of a pixel
// and the 4 x 4 weights they meet in vector loads, 16 fused multiply-adds
// per 4 + 1 shared loads of one pixel.  Ragged C, K and image edges are
// zero-filled at staging and masked at the store, so every shape launches.
//
// Bound on this card: at the paper's Table-4 sizes the conv is bound by
// operations (Conv1 at batch 2: 1.56 TMAC over 0.3 GB, 3.15 ms at the
// 989 TFLOP/s bf16 peak).  This first kernel multiplies on CUDA cores in
// fp32, so it runs far from that peak; its design keeps what the paper
// asks of the memory side (every weight tile reused by bx * by outputs,
// every input pixel by Fh * Fw * bk products from shared memory, the sum
// in registers), and tensor cores are later work.
#include "conv_tile.cuh"

namespace {

using conv::kCols;
using conv::kThreads;
constexpr int kMaxRows = 16;  // pixels per thread: 64 fp32 accumulators

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
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, N, H, W, C, K, Fh, Fw, s, bx,
                                   by, bc, bk, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
