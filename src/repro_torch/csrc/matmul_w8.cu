// int8-weight GEMM for Hopper: the port of
// repro/kernels/matmul_q.py::matmul_w8 (_matmul_w8_kernel, pallas_call at
// :90).
//
// C[M, N] = A[M, K] @ (Wq[K, N] * scale[N]), row-major; A and C fp32 or
// bf16, Wq int8, scale fp32 per output column (a per-tensor scale is
// expanded to a row by the wrapper).  The tile core is matmul_blocked's
// (gemm_tile.cuh) with B in int8: each B tile is staged at one byte per
// element, 16 columns per 16-byte cp.async (so N and bn are multiples of
// 16), and widened to fp32 at the multiply-add.  Because the scale
// depends only on the output column, sum_k a * (q * s) = s * sum_k a * q:
// the fp32 accumulator sums a * q over the whole K extent and the scale
// is applied once per output element in the epilogue, then one cast --
// the TPU kernel's order, and matmul_w8_ref's.
//
// Bound on this card: at decode (M = 8) every weight byte is read once,
// and the int8 stream halves the bf16 GEMM's bytes: (8, 4096, 4096) moves
// about 16.9 MB, 5 us at 3.35 TB/s.  At join spans (M = 512) it is flops
// bound.  Like matmul_blocked this first kernel multiplies on CUDA cores
// in fp32 (no mma/wgmma, no TMA); Hopper's int8 tensor cores would take
// int8 activations, which this w8a16 design does not have.
#include "gemm_tile.cuh"

namespace {

template <typename T> struct W8Map {
  const int8_t* W;
  T* C;
  const float* scale;  // (N,)
  int N, bn;
  __device__ gemm::ColRef<int8_t> b_col(int c) const {
    const int col = blockIdx.x * bn + c;
    return {col < N ? W + col : nullptr, N};
  }
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col < N) C[int64_t(m) * N + col] = gemm::from_f<T>(acc * scale[col]);
  }
};

template <typename T>
int dispatch(const void* a, const void* w, const float* scale, void* c,
             int M, int N, int K, int bm, int bk, int bn,
             cudaStream_t stream) {
  constexpr int VA = 16 / sizeof(T);
  const bool vec = gemm::aligned16(a) && gemm::aligned16(w) && K % VA == 0 &&
                   N % 16 == 0 && bk % VA == 0 && bn % 16 == 0;
  const W8Map<T> map{static_cast<const int8_t*>(w), static_cast<T*>(c),
                     scale, N, bn};
  return gemm::run<T, int8_t>(vec, a, map, M, K, bm, bk, bn,
                              (N + bn - 1) / bn, stream);
}

}  // namespace

// dtype (of A and C): 0 = float32, 1 = bfloat16.  N and bn must be
// multiples of 16 (the wrapper checks).  Returns a cudaError_t.
extern "C" int matmul_w8_fwd(int dtype, const void* a, const void* w,
                             const void* scale, void* c, int M, int N, int K,
                             int bm, int bk, int bn, void* stream) {
  if (N <= 0 || N % 16 || bn % 16 || scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (dtype == 0)
    return dispatch<float>(a, w, sc, c, M, N, K, bm, bk, bn, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(a, w, sc, c, M, N, K, bm, bk, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
