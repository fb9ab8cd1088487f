// The "mma" instance of the blocked GEMM (kernel row 6; port of
// repro/kernels/matmul_blocked.py::matmul_blocked, pallas_call at :91):
// bf16 A and B, M > 16, on the tensor cores.  Built as a library of its
// own beside matmul_blocked.cu (the fp32 and the transposed decode
// instances), so that the two compile in parallel; the design and bound
// are matmul_blocked.cu's header comment, the instance gemm_mma_inst.cuh's
// (over OneW with BlockedMap's plain store).
#include "gemm_mma_inst.cuh"

// dtype must be 1 (bfloat16), M > 16 and stages 2 or 3; arguments as
// matmul_blocked.cu's matmul_blocked_fwd.  Returns a cudaError_t.
extern "C" int matmul_blocked_mma_fwd(int dtype, const void* a,
                                      const void* b, void* c, int M, int N,
                                      int K, int bm, int bk, int bn,
                                      int stages, void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 ||
      bn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma(mma_inst::blocked_args(
      a, b, c, M, N, K, bm, bk, bn, stages,
      static_cast<cudaStream_t>(stream)));
}
