// Epilogue-fused blocked GEMM for Hopper: the port of
// repro/kernels/matmul_fused.py::matmul_fused (_fused_kernel :91,
// pallas_call at :173), for wide and for int8 weights.
//
// Y[M, N] = act(A[M, K] @ W[K, N] * scale + bias) * mul + residual, all
// row-major, fp32 or bf16 in and out.  W is in A's dtype
// (matmul_fused_fwd) or int8 (matmul_fused_w8_fwd: the TPU kernel's
// has_scale variant, with the per-column dequantisation scale).  scale
// and bias are fp32 rows (N,), mul and residual (M, N) blocks in the
// input dtype; each may be absent.  The tile core is matmul_blocked's
// (gemm_tile.cuh); an int8 W tile is staged at one byte per element
// (16 columns per 16-byte copy) and widened to fp32 at the multiply-add,
// so sum_k a * q is exact in the fp32 accumulator's order and the scale
// is applied once, in the epilogue.  The epilogue runs once per output
// element after the last k step, in fp32, in the order of the TPU kernel
// and matmul_fused_ref: scale, bias, activation (none, relu, gelu in
// jax.nn.gelu's tanh form, silu), mul, residual, then one cast.  The
// epilogue operands are read from global memory straight into registers
// at the store, never staged, so the shared-memory footprint is exactly
// matmul_blocked's (the TPU kernel double-buffered each of them in VMEM):
// the "matmul_fused" schedule key reuses the "matmul" tiles, and the
// int8 variant the "matmul_w8" ones with no re-check.
//
// Bound on this card: as matmul_blocked (and matmul_w8 for int8 W), plus
// the epilogue blocks read once.  What fusion saves is the (M, N)
// intermediates' round trips through HBM between the GEMM and its
// pointwise tail: at granite's MLP the gate output feeds the up
// projection's epilogue as `mul`, and the residual add rides the down
// projection.
#include <math.h>

#include <type_traits>

#include "gemm_tile.cuh"

namespace {

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

template <typename T, typename TW>
int dispatch(const void* a, const void* w, void* y, const float* scale,
             const float* bias, const void* mul, const void* res, int act,
             int M, int N, int K, int bm, int bk, int bn,
             cudaStream_t stream) {
  constexpr int VA = 16 / sizeof(T), VW = 16 / sizeof(TW);
  const bool vec = gemm::aligned16(a) && gemm::aligned16(w) && K % VA == 0 &&
                   N % VW == 0 && bk % VA == 0 && bn % VW == 0;
  const FusedMap<T, TW> map{static_cast<const TW*>(w), static_cast<T*>(y),
                            scale, bias, static_cast<const T*>(mul),
                            static_cast<const T*>(res), N, bn, act};
  return gemm::run<T, TW>(vec, a, map, M, K, bm, bk, bn, (N + bn - 1) / bn,
                          stream);
}

// dtype: 0 = float32, 1 = bfloat16 (A, Y, mul and res; W too unless
// kW8, where W is int8); act: 0 none, 1 relu, 2 gelu, 3 silu.  scale,
// bias, mul and res may be null.  Returns a cudaError_t.
template <bool kW8>
int fused_fwd(int dtype, const void* a, const void* w, void* y,
              const void* scale, const void* bias, const void* mul,
              const void* res, int act, int M, int N, int K, int bm, int bk,
              int bn, void* stream) {
  if (N <= 0 || act < kNone || act > kSilu)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  if (dtype == 0)
    return dispatch<float, std::conditional_t<kW8, int8_t, float>>(
        a, w, y, sc, bi, mul, res, act, M, N, K, bm, bk, bn, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16,
                    std::conditional_t<kW8, int8_t, __nv_bfloat16>>(
        a, w, y, sc, bi, mul, res, act, M, N, K, bm, bk, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// W in A's dtype.
extern "C" int matmul_fused_fwd(int dtype, const void* a, const void* w,
                                void* y, const void* scale, const void* bias,
                                const void* mul, const void* res, int act,
                                int M, int N, int K, int bm, int bk, int bn,
                                void* stream) {
  return fused_fwd<false>(dtype, a, w, y, scale, bias, mul, res, act, M, N,
                          K, bm, bk, bn, stream);
}

// W int8 (N and bn multiples of 16; the wrapper checks).
extern "C" int matmul_fused_w8_fwd(int dtype, const void* a, const void* w,
                                   void* y, const void* scale,
                                   const void* bias, const void* mul,
                                   const void* res, int act, int M, int N,
                                   int K, int bm, int bk, int bn,
                                   void* stream) {
  return fused_fwd<true>(dtype, a, w, y, scale, bias, mul, res, act, M, N,
                         K, bm, bk, bn, stream);
}
