// Blocked GEMM for Hopper: the port of
// repro/kernels/matmul_blocked.py::matmul_blocked (pallas_call at :91).
//
// C[M, N] = A[M, K] @ B[K, N], all row-major (weights are stored
// (d_in, d_out), so N is B's contiguous axis), fp32 or bf16 in and out.
// The tile core (gemm_tile.cuh: runtime (bm, bk, bn), A and B tiles
// staged two deep with cp.async, the fp32 accumulator in registers,
// ragged edges masked) with no epilogue: the sum is cast and stored.
//
// Bound on this card: at decode (M = 8) every weight byte is read once and
// the product is bytes bound at 3.35 TB/s; at prefill spans (M >= 512) it
// is flops bound.  This first kernel multiplies on CUDA cores in fp32
// (no mma/wgmma, no TMA), so at large M it stays far from the 989 TFLOP/s
// bf16 peak; tensor cores are a later step.
#include "gemm_tile.cuh"

namespace {

template <typename T> struct PlainMap {
  const T* B;
  T* C;
  int N, bn;
  __device__ gemm::ColRef<T> b_col(int c) const {
    const int col = blockIdx.x * bn + c;
    return {col < N ? B + col : nullptr, N};
  }
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col < N) C[int64_t(m) * N + col] = gemm::from_f<T>(acc);
  }
};

template <typename T>
int dispatch(const void* a, const void* b, void* c, int M, int N, int K,
             int bm, int bk, int bn, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = gemm::aligned16(a) && gemm::aligned16(b) && K % V == 0 &&
                   N % V == 0 && bk % V == 0 && bn % V == 0;
  const PlainMap<T> map{static_cast<const T*>(b), static_cast<T*>(c), N, bn};
  return gemm::run<T, T>(vec, a, map, M, K, bm, bk, bn, (N + bn - 1) / bn,
                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t.
extern "C" int matmul_blocked_fwd(int dtype, const void* a, const void* b,
                                  void* c, int M, int N, int K, int bm,
                                  int bk, int bn, void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, b, c, M, N, K, bm, bk, bn, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, b, c, M, N, K, bm, bk, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
