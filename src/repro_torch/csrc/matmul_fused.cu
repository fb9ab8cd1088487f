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
// * bf16, M > 16 ("mma") and M <= 16 ("mma_t", the transposed decode
//   product): gemm_mma_inst.cuh's two tensor-core instances, over one
//   weight matrix (OneW) with FusedMap's epilogue at the store.  The snap
//   picks mma_t's bn so that ceil(N / bn) >= 128 blocks fill the card,
//   and bk so that about 48 KB of W a block is in flight.  An int8 W is
//   staged raw and widened to bf16 on chip, exactly.
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
  if (dtype != 1 || bad_w8(kW8, w, N, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma_t(mma_args(kW8, a, w, y, sc, bi, mul, res, act, M,
                                      N, K, bm, bk, bn, stages, s));
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
