// int8-weight GEMM for Hopper: the port of
// repro/kernels/matmul_q.py::matmul_w8 (_matmul_w8_kernel, pallas_call at
// :90).
//
// C[M, N] = A[M, K] @ (Wq[K, N] * scale[N]), row-major; A and C fp32 or
// bf16, Wq int8, scale fp32 per output column (a per-tensor scale is
// expanded to a row by the wrapper).  The weight is staged at one byte per
// element, 16 columns per 16-byte cp.async (so N and bn are multiples of
// 16).  Because the scale depends only on the output column, sum_k a *
// (q * s) = s * sum_k a * q: the fp32 sum runs over the whole K extent
// and the scale is applied once per output element at the store, then
// one cast -- the TPU kernel's order, and matmul_w8_ref's (W8Map).  One
// block walks the whole K in a fixed order, so repeated launches agree
// bit for bit.
//
// Three instances (this library holds the first two; the third is
// matmul_w8_mma.cu, symbol matmul_w8_mma_fwd, built apart so that the two
// compile in parallel):
// * fp32 ("fma"): gemm_tile.cuh's CUDA-core tile core (matmul_blocked's),
//   the int8 tile widened to fp32 at the multiply-add (TF32 tensor cores
//   would break the fp32 tolerances);
// * bf16, M <= 16 ("mma_t") and M > 16 ("mma"): gemm_mma_inst.cuh's
//   tensor-core instances (row 9's), over one weight matrix, the staged
//   int8 rows widened to bf16 on chip exactly, mma.sync m16n8k16 with
//   fp32 sums.  Hopper's int8 tensor cores would take int8 activations,
//   which this w8a16 design does not have.
//
// Bound on this card: at decode (M = 8) every weight byte is read once:
// (8, 4096, 4096) moves about 16.9 MB, 5 us at 3.35 TB/s.  At join spans
// (M = 512) the operations, 2 M N K over the bf16 tensor cores.
#include "gemm_mma_inst.cuh"

namespace {

int fma_fwd(const void* a, const void* w, const float* scale, void* c,
            int M, int N, int K, int bm, int bk, int bn,
            cudaStream_t stream) {
  const bool vec = gemm::aligned16(a) && gemm::aligned16(w) && K % 4 == 0 &&
                   bk % 4 == 0;
  const mma_inst::W8Map<float> map{static_cast<const int8_t*>(w),
                                   static_cast<float*>(c), scale, N, bn};
  return gemm::run<float, int8_t>(vec, a, map, M, K, bm, bk, bn,
                                  (N + bn - 1) / bn, stream);
}

}  // namespace

// dtype (of A and C): 0 = float32 (CUDA cores; stages must be 2), 1 =
// bfloat16 with M <= 16 (the transposed instance, 2 to 4 stages; M > 16
// runs in matmul_w8_mma.cu).  N and bn must be multiples of 16 (the
// wrapper checks), and in bf16 W 16-byte aligned.  Returns a cudaError_t.
extern "C" int matmul_w8_fwd(int dtype, const void* a, const void* w,
                             const void* scale, void* c, int M, int N, int K,
                             int bm, int bk, int bn, int stages,
                             void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || N % 16 ||
      bn <= 0 || bn % 16 || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0 && stages == 2)
    return fma_fwd(a, w, sc, c, M, N, K, bm, bk, bn, s);
  if (dtype != 1 || !gemm::aligned16(w))  // int8 rows: 16-byte copies only
    return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma_t(
      mma_inst::w8_args(a, w, sc, c, M, N, K, bm, bk, bn, stages, s));
}
