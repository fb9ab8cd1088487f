// Blocked GEMM for Hopper: the port of
// repro/kernels/matmul_blocked.py::matmul_blocked (pallas_call at :91).
//
// C[M, N] = A[M, K] @ B[K, N], all row-major (weights are stored
// (d_in, d_out), so N is B's contiguous axis), fp32 or bf16 in and out,
// no epilogue: the fp32 sum is cast once and stored.  One block walks the
// whole K in a fixed order (no split-K, no atomics), so repeated launches
// agree bit for bit.  Ragged M, N and K edges are masked: every shape
// launches.
//
// Three instances (this library holds the first two; the third is
// matmul_blocked_mma.cu, symbol matmul_blocked_mma_fwd, built apart so
// that the two compile in parallel):
// * fp32 ("fma"): gemm_tile.cuh's CUDA-core tile core (runtime (bm, bk,
//   bn), A and B tiles staged two deep with cp.async, the fp32 sums in
//   registers); TF32 tensor cores would break the fp32 tolerances;
// * bf16, M <= 16 ("mma_t") and M > 16 ("mma"): gemm_mma_inst.cuh's
//   tensor-core instances (row 9's), over one weight matrix (OneW) with
//   BlockedMap's plain store: mma.sync m16n8k16 with fp32 sums.  At
//   decode the transposed instance puts bn columns of B on the m16 side,
//   and the "matmul" key's decode tile makes ceil(N / bn) >= 128 column
//   blocks fill the card.
//
// Bound on this card: at decode (M = 8) every weight byte is read once
// and the product is bytes bound at 3.35 TB/s ((8, 4096, 4096): 33.6 MB,
// 0.010 ms); at prefill spans (M >= 512) it is operations bound, 2 M N K
// over the bf16 tensor cores' 989 TFLOP/s.
#include "gemm_mma_inst.cuh"

namespace {

struct PlainMap {
  const float* B;
  float* C;
  int N, bn;
  __device__ gemm::ColRef<float> b_col(int c) const {
    const int col = blockIdx.x * bn + c;
    return {col < N ? B + col : nullptr, N};
  }
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col < N) C[int64_t(m) * N + col] = acc;
  }
};

int fma_fwd(const void* a, const void* b, void* c, int M, int N, int K,
            int bm, int bk, int bn, cudaStream_t stream) {
  const bool vec = gemm::aligned16(a) && gemm::aligned16(b) && K % 4 == 0 &&
                   N % 4 == 0 && bk % 4 == 0 && bn % 4 == 0;
  const PlainMap map{static_cast<const float*>(b), static_cast<float*>(c), N,
                     bn};
  return gemm::run<float, float>(vec, a, map, M, K, bm, bk, bn,
                                 (N + bn - 1) / bn, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; stages must be 2), 1 = bfloat16 with
// M <= 16 (the transposed instance, 2 to 4 stages; M > 16 runs in
// matmul_blocked_mma.cu).  Returns a cudaError_t.
extern "C" int matmul_blocked_fwd(int dtype, const void* a, const void* b,
                                  void* c, int M, int N, int K, int bm,
                                  int bk, int bn, int stages, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || bn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stages == 2)
    return fma_fwd(a, b, c, M, N, K, bm, bk, bn, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma_t(
      mma_inst::blocked_args(a, b, c, M, N, K, bm, bk, bn, stages, s));
}
