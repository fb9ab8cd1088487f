// Pieces of the epilogue-fused GEMM (kernel row 9) shared by its two
// libraries: matmul_fused.cu (the fp32 "fma" instance and the bf16
// transposed "mma_t" instance, M <= 16) and matmul_fused_mma.cu (the
// bf16 "mma" instance, M > 16), built apart so that the two compile in
// parallel.  The design is matmul_fused.cu's header comment; the two bf16
// instances are gemm_mma_inst.cuh's, over one weight matrix (OneW).  Here:
// the epilogue (FusedMap::store: scale, bias, activation, mul, residual
// in fp32, one cast) and the launch arguments.
#pragma once

#include <math.h>

#include "gemm_mma_inst.cuh"

namespace fused {

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kSilu = 3 };

__device__ __forceinline__ float activate(int act, float y) {
  switch (act) {
    case kRelu:
      return fmaxf(y, 0.f);
    case kGelu: {  // jax.nn.gelu(approximate=True)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * y * (1.f + tanhf(c * (y + 0.044715f * y * y * y)));
    }
    case kSilu:
      return y / (1.f + expf(-y));
    default:
      return y;
  }
}

template <typename T, typename TW> struct FusedMap {
  const TW* W;
  T* Y;
  const float* scale;  // (N,) or nullptr
  const float* bias;   // (N,) or nullptr
  const T* mul;        // (M, N) or nullptr
  const T* res;        // (M, N) or nullptr
  int N, bn, act;
  __device__ gemm::ColRef<TW> b_col(int c) const {
    const int col = blockIdx.x * bn + c;
    return {col < N ? W + col : nullptr, N};
  }
  __device__ void store(int m, int c, float acc) const {
    const int col = blockIdx.x * bn + c;
    if (col >= N) return;
    const int64_t i = int64_t(m) * N + col;
    float y = acc;
    if (scale != nullptr) y *= scale[col];
    if (bias != nullptr) y += bias[col];
    y = activate(act, y);
    if (mul != nullptr) y *= gemm::to_f(mul[i]);
    if (res != nullptr) y += gemm::to_f(res[i]);
    Y[i] = gemm::from_f<T>(y);
  }
};

using gemm_mma::bf16;
using Map = FusedMap<bf16, bf16>;  // store() only: W is staged directly
using MmaArgs = mma_inst::Args<mma_inst::OneW, Map>;

// An int8 W is staged by 16-byte copies only (the wrapper checks the
// operands), and A and a wide W by 16-byte copies where they allow it.
inline bool bad_w8(bool w8, const void* w, int N, int bn) {
  return w8 && (!gemm::aligned16(w) || N % 16 || bn % 16);
}
inline MmaArgs mma_args(bool w8, const void* a, const void* w, void* y,
                        const float* scale, const float* bias,
                        const void* mul, const void* res, int act, int M,
                        int N, int K, int bm, int bk, int bn, int stages,
                        cudaStream_t stream) {
  const bool vec = gemm::aligned16(a) && gemm::aligned16(w) && K % 8 == 0 &&
                   bk % 8 == 0 && N % 8 == 0 && bn % 8 == 0;
  return MmaArgs{static_cast<const bf16*>(a), mma_inst::OneW{w, N},
                 Map{nullptr, static_cast<bf16*>(y), scale, bias,
                     static_cast<const bf16*>(mul),
                     static_cast<const bf16*>(res), N, bn, act},
                 M, K, bm, bk, bn, stages, vec, w8, stream};
}

inline bool bad_dims(int M, int N, int K, int bm, int bk, int bn, int act) {
  return M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || bn <= 0 ||
         act < kNone || act > kSilu;
}

}  // namespace fused
