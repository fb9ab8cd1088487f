// The "mma" instance of the epilogue-fused GEMM (kernel row 9; port of
// repro/kernels/matmul_fused.py::matmul_fused, pallas_call at :173): bf16
// A, a bf16 or int8 W, M > 16, on the tensor cores.  Built as a library of
// its own beside matmul_fused.cu (the fp32 and the transposed decode
// instances), so that the two compile in parallel; the design and bound
// are matmul_fused.cu's header comment, the shared pieces fused_gemm.cuh.
#include "fused_gemm.cuh"

namespace {

using namespace fused;

// the 22 (mt, nt) instances of mma_layout
template <bool kW8>
int fused_mma_fwd(int dtype, const void* a, const void* w, void* y,
                  const void* scale, const void* bias, const void* mul,
                  const void* res, int act, int M, int N, int K, int bm,
                  int bk, int bn, int stages, void* stream) {
  if (bad_dims(M, N, K, bm, bk, bn, act) || dtype != 1 ||
      bad_w8(kW8, w, N, bn))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma(
      mma_args(kW8, a, w, y, static_cast<const float*>(scale),
               static_cast<const float*>(bias), mul, res, act, M, N, K, bm,
               bk, bn, stages, static_cast<cudaStream_t>(stream)));
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
