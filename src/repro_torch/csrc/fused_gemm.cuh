// Pieces of the epilogue-fused GEMM (kernel row 9) shared by its two
// libraries: matmul_fused.cu (the fp32 "fma" instance and the bf16
// transposed "mma_t" instance, M <= 16) and matmul_fused_mma.cu (the
// bf16 "mma" instance, M > 16), built apart so that the two compile in
// parallel.  The design is matmul_fused.cu's header comment.  Here: the
// epilogue (FusedMap::store: scale, bias, activation, mul, residual in
// fp32, one cast), the int8 staging and its widening into a swizzled
// bf16 tile, the shared-memory footprints (mirrored by
// kernels/matmul_fused.py::smem_bytes_required), the fragment store
// through the epilogue, and the launch arguments.
#pragma once

#include <math.h>

#include "gemm_mma.cuh"

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
using gemm_mma::ceil_div;
using gemm_mma::Layout;
using gemm_mma::round_up;
using gemm_mma::Tile;
using Map = FusedMap<bf16, bf16>;  // store() only: W is staged directly

constexpr int kTMaxRows = 16;      // tokens of the transposed instance

// four int8 (one word) as four bf16 (two words), exactly: byte b + 128
// becomes the low mantissa byte of 2^23 (gemm_tile.cuh's load4), and
// every integer of magnitude <= 256 is a bf16
__device__ __forceinline__ uint2 widen4(unsigned u) {
  u ^= 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443));
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(f0 - 8388736.f, f1 - 8388736.f);
  const __nv_bfloat162 hi =
      __floats2bfloat162_rn(f2 - 8388736.f, f3 - 8388736.f);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                    *reinterpret_cast<const unsigned*>(&hi));
}

// Stage rows [0, nr) of an int8 tile, w16 16-byte chunks a row, in rows
// of w16 chunks (unswizzled): chunk c of row r is W[(r0 + r) * ldw + c0 +
// 16 c ..] for r < r_ok and 16 c < c_ok (whole chunks), else zero.
__device__ __forceinline__ void stage_i8(int8_t* s, const int8_t* W,
                                         int64_t ldw, int r0, int nr,
                                         int r_ok, int c0, int c_ok,
                                         int w16) {
  const uint32_t base = mma::smem_addr(s);
  for (int i = threadIdx.x; i < nr * w16; i += gemm_mma::kThreads) {
    const int r = i / w16, c = i - r * w16;
    const bool in = r < r_ok && c * 16 < c_ok;
    const int8_t* src = in ? W + int64_t(r0 + r) * ldw + c0 + c * 16 : W;
    gemm_mma::cp_async16_zfill(base + i * 16, src, in ? 16 : 0);
  }
}

// Widen a staged int8 tile (nr rows of w16 chunks) into the bf16 tile t
// (rows of 2 w16 chunks, swizzled as Tile lays them out).
__device__ __forceinline__ void widen(bf16* dst, const int8_t* src, int nr,
                                      int w16, const Tile& t) {
  for (int i = threadIdx.x; i < nr * w16; i += gemm_mma::kThreads) {
    const int r = i / w16, c = i - r * w16;
    const uint4 u = *reinterpret_cast<const uint4*>(src + i * 16);
    const uint2 a = widen4(u.x), b = widen4(u.y);
    const uint2 c2 = widen4(u.z), d = widen4(u.w);
    *reinterpret_cast<uint4*>(dst + t.at(r, 2 * c) * 8) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(dst + t.at(r, 2 * c + 1) * 8) =
        make_uint4(c2.x, c2.y, d.x, d.y);
  }
}

// 16-byte chunks of one staged W step of bkp rows and bn columns: the
// swizzled bf16 tile, or the raw int8 rows
__host__ __device__ inline int w_chunks(int bkp, int bn, bool w8) {
  return w8 ? bkp * (bn / 16) : bkp * Tile(ceil_div(bn, 8)).ld;
}

// Dynamic shared memory of both bf16 instances (kernels/matmul_fused.py::
// smem_bytes_required): `stages` buffers of `rows` rows of A and one step
// of W, the widened W tile of an int8 W; mma_t's warp sums overlay them.
inline int mma_smem(int rows, int bk, int bn, int stages, bool w8) {
  const int bkp = round_up(bk, 16);
  const int stage = rows * Tile(bkp / 8).ld + w_chunks(bkp, bn, w8);
  return (stages * stage + (w8 ? bkp * Tile(ceil_div(bn, 8)).ld : 0)) * 16;
}
inline int mma_t_smem(int nt, int bk, int bn, int stages, bool w8) {
  const int sums = gemm_mma::kWarps * (bn / 16) * nt * 4 * 32 * 4;
  const int staged = mma_smem(8 * nt, bk, bn, stages, w8);
  return staged > sums ? staged : sums;
}

// the store of a warp's fragments, element by element through the map:
// rows from the tile's mt0-th m16 tile, columns from its nt0-th n8 tile
template <int MT, int NT>
__device__ __forceinline__ void store_frags(const float (&d)[MT][NT][4],
                                            const Map& map, int m0,
                                            int m_ok, int n_ok, int mt0,
                                            int nt0, int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (mt0 + mt) * 16 + g + hr * 8;
      if (r >= m_ok) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = (nt0 + nt) * 8 + c2 + e;
          if (c < n_ok) map.store(m0 + r, c, d[mt][nt][hr * 2 + e]);
        }
    }
}

// raise a kernel instance's dynamic shared-memory limit once, to the
// largest tile seen (the attribute call is not free on the host)
template <typename Kernel>
int allow_smem(Kernel kernel, int smem, int& smem_set) {
  if (smem <= smem_set) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  smem_set = smem;
  return 0;
}

struct MmaArgs {
  const bf16* a;
  const void* w;
  Map map;
  int M, N, K, bm, bk, bn, stages, vec, w8;
  cudaStream_t stream;
};

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
  return MmaArgs{static_cast<const bf16*>(a), w,
                 Map{nullptr, static_cast<bf16*>(y), scale, bias,
                     static_cast<const bf16*>(mul),
                     static_cast<const bf16*>(res), N, bn, act},
                 M, N, K, bm, bk, bn, stages, vec, w8, stream};
}

inline bool bad_dims(int M, int N, int K, int bm, int bk, int bn, int act) {
  return M <= 0 || N <= 0 || K <= 0 || bm <= 0 || bk <= 0 || bn <= 0 ||
         act < kNone || act > kSilu;
}

}  // namespace fused
