// The "mma" instance of the fused QKV projection (kernel row 11; port of
// repro/kernels/qkv_fused.py::qkv_fused, pallas_call at :103): bf16, M >
// 16, on the tensor cores over the segment-major grid.  Built as a
// library of its own beside qkv_fused.cu (the fp32 and the transposed
// decode instances), so that the two compile in parallel; the design and
// bound are qkv_fused.cu's header comment, the instance
// gemm_mma_inst.cuh's.
#include "gemm_mma_inst.cuh"

// dtype must be 1 (bfloat16), M > 16 and stages 2 or 3; arguments as
// qkv_fused.cu's qkv_fused_fwd.  Returns a cudaError_t.
extern "C" int qkv_fused_mma_fwd(int dtype, const void* x, const void* wq,
                                 const void* wk, const void* wv, void* q,
                                 void* k, void* v, int M, int nkv, int K,
                                 int groups, int bm, int bk, int bn,
                                 int stages, void* stream) {
  if (dtype != 1 || M <= 0 || nkv <= 0 || K <= 0 || groups <= 0 ||
      bm <= 0 || bk <= 0 || bn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma(mma_inst::qkv_args(
      x, wq, wk, wv, q, k, v, M, nkv, K, groups, bm, bk, bn, stages,
      static_cast<cudaStream_t>(stream)));
}
