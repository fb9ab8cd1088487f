// The "mma" instance of the epilogue-fused GEMM (kernel row 9; port of
// repro/kernels/matmul_fused.py::matmul_fused, pallas_call at :173): bf16
// A, a bf16 or int8 W, M > 16, on the tensor cores.  Built as a library of
// its own beside matmul_fused.cu (the fp32 and the transposed decode
// instances), so that the two compile in parallel; the design and bound
// are matmul_fused.cu's header comment, the shared pieces fused_gemm.cuh.
#include "fused_gemm.cuh"

namespace {

using namespace fused;

// Y[M, N] tiled (bm, bk, bn), M > 16; block (x, y) owns columns x * bn
// and rows y * bm.  One stage: bm rows of A (bkp / 8 chunks each, tx),
// then bkp rows of W (tw; int8: bn / 16 raw chunks each); an int8 W adds
// one widened tile after the stages.  Rows and columns past the tile
// read its last one and are never stored.
template <int MT, int NT>
__global__ void __launch_bounds__(gemm_mma::kThreads, 2)
fused_mma_kernel(const bf16* __restrict__ A, const void* __restrict__ W,
                 Map map, int M, int N, int K, int bm, int bk, int bn,
                 int wn_count, int stages, int vec, int w8) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bkp = round_up(bk, 16);
  const Tile tx(bkp / 8), tw(ceil_div(bn, 8));
  const int x_size = bm * tx.ld;                     // chunks
  const int stage = x_size + w_chunks(bkp, bn, w8);  // chunks
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16* const wide = base + stages * stage * 8;      // int8: widened W
  const int m0 = blockIdx.y * bm, n0 = blockIdx.x * bn;
  const int m_ok = min(bm, M - m0), n_ok = min(bn, N - n0);
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
        if (w8)
          stage_i8(reinterpret_cast<int8_t*>(st + x_size * 8),
                   static_cast<const int8_t*>(W), N, k0, bkp, k_ok, n0,
                   n_ok, bn / 16);
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
  store_frags(acc, map, m0, m_ok, n_ok, wm * MT, wn * NT, lane);
}

template <int MT, int NT>
int launch_mma(const MmaArgs& a, int wn) {
  static int smem_set = 48 * 1024;
  const int smem = mma_smem(a.bm, a.bk, a.bn, a.stages, a.w8);
  auto kernel = fused_mma_kernel<MT, NT>;
  const int err = allow_smem(kernel, smem, smem_set);
  if (err) return err;
  const dim3 grid(ceil_div(a.N, a.bn), ceil_div(a.M, a.bm));
  kernel<<<grid, gemm_mma::kThreads, smem, a.stream>>>(
      a.a, a.w, a.map, a.M, a.N, a.K, a.bm, a.bk, a.bn, wn, a.stages, a.vec,
      a.w8);
  return static_cast<int>(cudaGetLastError());
}

// the instance of the layout's (mt, nt): mt <= 8, nt a power of two <= 8,
// mt * nt <= 16 (22 pairs; matmul_bwd.cu's set)
template <int MT = 1, int NT = 1>
int dispatch_mma(const MmaArgs& a, const Layout& l) {
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

// dispatch in launch_mma's order: the 22 (mt, nt) of mma_layout
template <bool kW8>
int fused_mma_fwd(int dtype, const void* a, const void* w, void* y,
                  const void* scale, const void* bias, const void* mul,
                  const void* res, int act, int M, int N, int K, int bm,
                  int bk, int bn, int stages, void* stream) {
  if (bad_dims(M, N, K, bm, bk, bn, act) || dtype != 1 || M <= kTMaxRows ||
      (stages != 2 && stages != 3) || bad_w8(kW8, w, N, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout l = gemm_mma::mma_layout(bm, bn);
  if (l.wm == 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_mma(
      mma_args(kW8, a, w, y, static_cast<const float*>(scale),
               static_cast<const float*>(bias), mul, res, act, M, N, K, bm,
               bk, bn, stages, static_cast<cudaStream_t>(stream)),
      l);
}

}  // namespace

// dtype must be 1 (bfloat16) and M > 16; arguments as matmul_fused.cu's
// matmul_fused_fwd (the names differ, so that each library exports only
// its own instances).  W in A's dtype.  Returns a cudaError_t.
extern "C" int matmul_fused_mma_fwd(int dtype, const void* a,
                                    const void* w, void* y,
                                    const void* scale, const void* bias,
                                    const void* mul, const void* res,
                                    int act, int M, int N, int K, int bm,
                                    int bk, int bn, int stages,
                                    void* stream) {
  return fused_mma_fwd<false>(dtype, a, w, y, scale, bias, mul, res, act, M,
                              N, K, bm, bk, bn, stages, stream);
}

// W int8 (N and bn multiples of 16; the wrapper checks).
extern "C" int matmul_fused_mma_w8_fwd(int dtype, const void* a,
                                       const void* w, void* y,
                                       const void* scale, const void* bias,
                                       const void* mul, const void* res,
                                       int act, int M, int N, int K, int bm,
                                       int bk, int bn, int stages,
                                       void* stream) {
  return fused_mma_fwd<true>(dtype, a, w, y, scale, bias, mul, res, act, M,
                             N, K, bm, bk, bn, stages, stream);
}
