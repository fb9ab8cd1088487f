// Epilogue-fused blocked GEMM for Hopper: the port of
// repro/kernels/matmul_fused.py::matmul_fused (_fused_kernel :91,
// pallas_call at :173), for wide and for int8 weights.
//
// Y[M, N] = act(A[M, K] @ W[K, N] * scale + bias) * mul + residual, all
// row-major, fp32 or bf16 in and out.  W is in A's dtype
// (matmul_fused_fwd) or int8 (matmul_fused_w8_fwd: the TPU kernel's
// has_scale variant, with the per-column dequantisation scale).  scale
// and bias are fp32 rows (N,), mul and residual (M, N) blocks in the
// input dtype; each may be absent.  The epilogue runs once per output
// element after the last k step, in fp32, in the order of the TPU kernel
// and matmul_fused_ref: scale, bias, activation (none, relu, gelu in
// jax.nn.gelu's tanh form, silu), mul, residual, then one cast
// (FusedMap::store).  The epilogue operands are read from global memory
// straight into registers at the store, never staged (the TPU kernel
// double-buffered each of them in VMEM).  An int8 W is staged at one
// byte per weight (16 weights per 16-byte copy), so HBM and L2 move one
// byte a weight, and the scale is applied once, in the epilogue:
// (a @ q) * s.  One block walks the whole K in a fixed order (no
// split-K, no atomics), so repeated launches agree bit for bit.
//
// Three instances (this library holds the first two; the third is
// matmul_fused_mma.cu, whose symbols are matmul_fused_mma_fwd and
// matmul_fused_mma_w8_fwd, built apart so that the two compile in
// parallel; their shared pieces are fused_gemm.cuh):
// * fp32 ("fma"): gemm_tile.cuh's CUDA-core tile core (matmul_blocked's;
//   TF32 tensor cores would break the fp32 tolerances); an int8 W tile
//   is widened to fp32 at the multiply-add.
// * bf16, M > 16 ("mma", fused_mma_kernel): the fragment core of
//   gemm_mma.cuh, mma.sync m16n8k16 with fp32 sums.  The 8 warps tile
//   the (bm, bn) output as mma_layout's wm x wn grid of mt m16 x nt n8
//   fragments; each reduction step stages bm rows of A (plain ldmatrix,
//   as the dgrad's NT kernel) and bk rows of W (ldmatrix.trans, as its TN
//   kernel), 16-byte chunks XOR-swizzled by row, 2 or 3 cp.async stages.
// * bf16, M <= 16 ("mma_t", fused_mma_t_kernel): decode.  An m16
//   fragment of tokens would be at least half empty, and output tiles
//   wide enough to feed it leave most of the 132 SMs idle at N = 4096
//   (256 columns: 16 blocks).  The block
//   computes the transposed product Y^T = W^T . A^T: its bn = 16 MT
//   columns of W sit on the m16 side (A fragments by ldmatrix.trans of
//   the staged [bk][bn] W tile), the M tokens are NT = 1 or 2 n8 tiles
//   (B fragments by plain ldmatrix of the staged token rows; slots past
//   M stage as zero and are never stored).  The 8 warps split each
//   stage's k16 steps among themselves and, after the last, sum their C
//   fragments through shared memory in warp order; 4 cp.async stages.
//   The snap picks bn so that ceil(N / bn) >= 128 blocks fill the card,
//   and bk so that about 48 KB of W a block is in flight.
// An int8 W (both bf16 instances) is widened to bf16 by one pass over
// the staged tile into a swizzled bf16 tile (exact: |q| <= 127 fits
// bf16's 8-bit significand), then read as a wide one.
//
// Bound on this card: at decode (M = 8) the bytes of W, 2 (or 1) bytes a
// weight read once: the down projection's 105 MB (52 MB int8) in 0.031
// (0.016) ms at 3.35 TB/s; at M = 512 the operations, 2 M N K over the
// tensor cores.  What fusion saves is the (M, N) intermediates' round
// trips through HBM between the GEMM and its pointwise tail: at
// granite's MLP the gate output feeds the up projection's epilogue as
// `mul`, and the residual add rides the down projection.
#include <type_traits>

#include "fused_gemm.cuh"

namespace {

using namespace fused;

// ------------------------------------------------- fp32: CUDA cores --

template <typename TW>
int fma_fwd(const void* a, const void* w, void* y, const float* scale,
            const float* bias, const void* mul, const void* res, int act,
            int M, int N, int K, int bm, int bk, int bn,
            cudaStream_t stream) {
  constexpr int VA = 4, VW = 16 / sizeof(TW);
  const bool vec = gemm::aligned16(a) && gemm::aligned16(w) && K % VA == 0 &&
                   N % VW == 0 && bk % VA == 0 && bn % VW == 0;
  const FusedMap<float, TW> map{static_cast<const TW*>(w),
                                static_cast<float*>(y), scale, bias,
                                static_cast<const float*>(mul),
                                static_cast<const float*>(res), N, bn, act};
  return gemm::run<float, TW>(vec, a, map, M, K, bm, bk, bn,
                              (N + bn - 1) / bn, stream);
}

// ----------------------------------- bf16, M <= 16: the transposed one --

// Y[M, N] for M <= 16 as Y^T = W^T . A^T; block x owns the BN = 16 MT
// columns x * BN.  One stage: the 8 NT token rows of A (bkp / 8 chunks
// each, tx; rows past M zero), then bkp rows of W (tw; int8: BN / 16 raw
// chunks each); an int8 W adds one widened tile.  Warp w multiplies k16
// steps w, w + 8, ... of each stage; the warps' sums are added in warp
// order after the last.
template <int MT, int NT>
__global__ void __launch_bounds__(gemm_mma::kThreads)
fused_mma_t_kernel(const bf16* __restrict__ A, const void* __restrict__ W,
                   Map map, int M, int N, int K, int bk, int stages,
                   int vec, int w8) {
  constexpr int BN = 16 * MT, XR = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = round_up(bk, 16);
  const Tile tx(bkp / 8), tw(BN / 8);
  const int x_size = XR * tx.ld;                     // chunks
  const int stage = x_size + w_chunks(bkp, BN, w8);  // chunks
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16* const wide = base + stages * stage * 8;      // int8: widened W
  const int n0 = blockIdx.x * BN, n_ok = min(BN, N - n0);
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
        if (w8)
          stage_i8(reinterpret_cast<int8_t*>(st + x_size * 8),
                   static_cast<const int8_t*>(W), N, k0, bkp, k_ok, n0,
                   n_ok, BN / 16);
        else
          gemm_mma::stage(st + x_size * 8, static_cast<const bf16*>(W), N,
                          k0, bkp, k_ok, n0, n_ok, tw, vec);
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
    if (tok < M && col < n_ok) map.store(tok, col, s);
  }
}

template <int MT, int NT>
int launch_mma_t(const MmaArgs& a) {
  static int smem_set = 48 * 1024;
  const int smem = mma_t_smem(NT, a.bk, a.bn, a.stages, a.w8);
  auto kernel = fused_mma_t_kernel<MT, NT>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid(ceil_div(a.N, a.bn), 1);
  kernel<<<grid, gemm_mma::kThreads, smem, a.stream>>>(
      a.a, a.w, a.map, a.M, a.N, a.K, a.bk, a.stages, a.vec, a.w8);
  return static_cast<int>(cudaGetLastError());
}

// bn = 16, 32, 64 or 128 W columns; NT = 1 (M <= 8) or 2 token tiles
template <int NT>
int dispatch_mma_t(const MmaArgs& a) {
  switch (a.bn) {
    case 16: return launch_mma_t<1, NT>(a);
    case 32: return launch_mma_t<2, NT>(a);
    case 64: return launch_mma_t<4, NT>(a);
    case 128: return launch_mma_t<8, NT>(a);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; stages must be 2), 1 = bfloat16 with
// M <= 16 (the transposed instance, 2 to 4 stages; M > 16 runs in
// matmul_fused_mma.cu); act: 0 none, 1 relu, 2 gelu, 3 silu.  scale,
// bias, mul and res may be null.  Returns a cudaError_t.
template <bool kW8>
int fused_fwd(int dtype, const void* a, const void* w, void* y,
              const void* scale, const void* bias, const void* mul,
              const void* res, int act, int M, int N, int K, int bm, int bk,
              int bn, int stages, void* stream) {
  if (bad_dims(M, N, K, bm, bk, bn, act))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0 && stages == 2)
    return fma_fwd<std::conditional_t<kW8, int8_t, float>>(
        a, w, y, sc, bi, mul, res, act, M, N, K, bm, bk, bn, s);
  if (dtype != 1 || M > kTMaxRows || stages < 2 || stages > 4 ||
      bad_w8(kW8, w, N, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const MmaArgs args = mma_args(kW8, a, w, y, sc, bi, mul, res, act, M, N, K,
                                bm, bk, bn, stages, s);
  return M <= 8 ? dispatch_mma_t<1>(args) : dispatch_mma_t<2>(args);
}

// W in A's dtype.
extern "C" int matmul_fused_fwd(int dtype, const void* a, const void* w,
                                void* y, const void* scale, const void* bias,
                                const void* mul, const void* res, int act,
                                int M, int N, int K, int bm, int bk, int bn,
                                int stages, void* stream) {
  return fused_fwd<false>(dtype, a, w, y, scale, bias, mul, res, act, M, N,
                          K, bm, bk, bn, stages, stream);
}

// W int8 (N and bn multiples of 16; the wrapper checks).
extern "C" int matmul_fused_w8_fwd(int dtype, const void* a, const void* w,
                                   void* y, const void* scale,
                                   const void* bias, const void* mul,
                                   const void* res, int act, int M, int N,
                                   int K, int bm, int bk, int bn, int stages,
                                   void* stream) {
  return fused_fwd<true>(dtype, a, w, y, scale, bias, mul, res, act, M, N,
                         K, bm, bk, bn, stages, stream);
}
