// The "mma" instance of the int8-weight GEMM (kernel row 10; port of
// repro/kernels/matmul_q.py::matmul_w8, pallas_call at :90): bf16 A, an
// int8 W, M > 16, on the tensor cores.  Built as a library of its own
// beside matmul_w8.cu (the fp32 and the transposed decode instances), so
// that the two compile in parallel; the design and bound are
// matmul_w8.cu's header comment, the instance gemm_mma_inst.cuh's.
#include "gemm_mma_inst.cuh"

// dtype must be 1 (bfloat16), M > 16 and stages 2 or 3; arguments as
// matmul_w8.cu's matmul_w8_fwd.  Returns a cudaError_t.
extern "C" int matmul_w8_mma_fwd(int dtype, const void* a, const void* w,
                                 const void* scale, void* c, int M, int N,
                                 int K, int bm, int bk, int bn, int stages,
                                 void* stream) {
  if (dtype != 1 || M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 ||
      N % 16 || bn <= 0 || bn % 16 || scale == nullptr ||
      !gemm::aligned16(w))
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma(mma_inst::w8_args(
      a, w, static_cast<const float*>(scale), c, M, N, K, bm, bk, bn, stages,
      static_cast<cudaStream_t>(stream)));
}
