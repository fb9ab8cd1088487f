// Tensor-core GEMM fragment core: the bf16 instances of the dgrad GEMMs
// (matmul_bwd.cu: nt_mma_kernel, tn_mma_kernel) and of the epilogue-fused
// GEMM (matmul_fused.cu: fused_mma_kernel, fused_mma_t_kernel), built on
// mma_frag.cuh.  matmul_blocked.cu, matmul_w8.cu and qkv_fused.cu keep
// gemm_tile.cuh's CUDA-core core.
//
// A block of 256 threads (8 warps) owns one (rows x cols) output tile and
// holds its fp32 sums in registers across the whole reduction.  The warps
// tile it as wm x wn warps of mt m16 x nt n8 fragments each (mma_layout;
// mt * nt <= 16: 64 fp32 sums a thread, so two blocks share an SM's
// registers).  Every product is mma.sync m16n8k16 with fp32 sums; the
// reduction is staged in whole k16 steps, zero-filled past its end.
//
// Staging.  An operand tile lives in shared memory as rows of w 16-byte
// chunks (8 bf16 each), ld chunks apart (Tile): chunk c of row r sits at
// chunk c ^ ((r >> shift) & mask) of its row.  The 8 rows of one ldmatrix
// sub-matrix (8 consecutive rows from a multiple of 8, at one chunk) then
// fall into 8 distinct bank groups (16-byte units modulo 8): a power of
// two w >= 8 is swizzled by r & 7, w = 4 and 2 by the row's 128-byte line
// (r >> 1, r >> 2), an odd w needs nothing, and any other w is padded by
// one chunk to odd.  The row and column of an element are what the
// caller makes them: the NT kernel stages output rows (or columns) of
// reduction elements, and reads fragments with plain ldmatrix; the TN
// kernel stages reduction rows of output rows (or columns), and reads
// them with ldmatrix.trans.  Copies are 16-byte cp.async where the
// operands allow it (aligned, whole chunks in range), else one element
// at a time; what lies past the matrix or the step is zero.
//
// Pipeline.  `stages` (2 to 4) buffers of one reduction step each: step
// t + stages - 1 is copied by cp.async while step t is multiplied, with
// one barrier a step.  The copy loop is kept short (one division a
// staged tile, a strided address a chunk): its instructions compete with
// the mma loop's for issue slots.  One block walks the whole reduction
// in a fixed order (no split-K, no atomics), so repeated launches agree
// bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "gemm_tile.cuh"
#include "mma_frag.cuh"

namespace gemm_mma {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFrags = 16;  // m16 x n8 fragments a warp holds
constexpr int kMaxMt = 8;      // m16 fragments a warp holds
constexpr int kMaxNt = 8;      // n8 fragments a warp holds (a power of two)

__host__ __device__ inline int ceil_div(int a, int b) {
  return (a + b - 1) / b;
}
__host__ __device__ inline int round_up(int a, int b) {
  return ceil_div(a, b) * b;
}

struct Layout {
  int wm, wn, mt, nt;  // warps down M and across N; m16 and n8 tiles each
};

// The warp grid of a (rows x cols) output tile: for wn = 1, 2, 4, 8 warps
// across N (wm = 8 / wn down M), mt = ceil(rows / 16 / wm) and nt the
// power of two >= ceil(cols / 8 / wn) (a B ldmatrix.x4 loads a pair of
// n8 tiles), with mt <= 8, nt <= 8 and mt * nt <= 16; of those the
// fewest computed rows (16 wm mt), then the fewest computed elements,
// then the fewest fragment loads a k16 step (mt + ceil(nt / 2)), then the
// fewest warps across N.  wm == 0 where none holds the tile.
// kernels/matmul_bwd.py::mma_layout is the same function.
inline Layout mma_layout(int rows, int cols) {
  const int mt_all = ceil_div(rows, 16), nt_all = ceil_div(cols, 8);
  Layout best{0, 0, 0, 0};
  long best_key[3] = {0, 0, 0};
  for (int wn = 1; wn <= kWarps; wn *= 2) {
    const int wm = kWarps / wn;
    int nt = 1;
    while (nt < ceil_div(nt_all, wn)) nt *= 2;
    const Layout l{wm, wn, ceil_div(mt_all, wm), nt};
    if (l.mt > kMaxMt || l.nt > kMaxNt || l.mt * l.nt > kMaxFrags) continue;
    const long key[3] = {16L * wm * l.mt, 16L * wm * l.mt * 8 * wn * l.nt,
                         l.mt + (l.nt + 1) / 2};
    bool better = best.wm == 0;
    for (int i = 0; i < 3 && !better; ++i) {
      if (key[i] != best_key[i]) {
        better = key[i] < best_key[i];
        break;
      }
    }
    if (better) {
      best = l;
      for (int i = 0; i < 3; ++i) best_key[i] = key[i];
    }
  }
  return best;
}

// A staged tile's rows of 16-byte chunks (see the header comment);
// kernels/matmul_bwd.py::staged_chunks is the same rule.
struct Tile {
  int w, ld, shift, mask;
  __host__ __device__ explicit Tile(int w_) : w(w_), shift(0), mask(0) {
    const bool pow2 = (w & (w - 1)) == 0;
    ld = (w & 1) || pow2 ? w : w + 1;
    if (pow2 && w >= 2) {
      int lw = 0;
      while ((1 << lw) < w) ++lw;
      shift = lw >= 3 ? 0 : 3 - lw;
      mask = (w < 8 ? w : 8) - 1;
    }
  }
  __host__ __device__ int swz(int r) const { return (r >> shift) & mask; }
  // chunk index of chunk c of row r
  __host__ __device__ int at(int r, int c) const {
    return r * ld + (c ^ swz(r));
  }
};

// 16 bytes from global to shared memory, asynchronously; bytes past
// `bytes` (16 or 0) are zero-filled and not read (src must still be an
// address of the operand)
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst,
                                                 const void* src,
                                                 int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// Stage rows [0, nr) of tile t at s from X (row stride ldx elements):
// element j of row r is X[(r0 + r) * ldx + c0 + j] for r < r_ok and
// j < c_ok, else zero.  vec: 16-byte cp.async copies (X and ldx 16-byte
// aligned, c0 and c_ok whole chunks); otherwise element by element.
// Thread i copies chunk i % w of rows i / w, i / w + 256 / w, ...  Where
// w is a power of two up to 32 (every tile the model picks), those rows
// are a whole number of swizzle periods (8 rows) apart, so a thread's
// chunks sit at one shared-memory stride: the copy loop is an address
// step and one zero-filling cp.async a chunk.
__device__ __forceinline__ void stage(bf16* s, const bf16* X, int64_t ldx,
                                      int r0, int nr, int r_ok, int c0,
                                      int c_ok, const Tile& t, bool vec) {
  if (vec && (t.w & (t.w - 1)) == 0 && t.w <= 32) {
    const int lw = __ffs(t.w) - 1, rpi = kThreads >> lw;
    const int c = threadIdx.x & (t.w - 1), r_first = threadIdx.x >> lw;
    const bool c_in = c * 8 < c_ok;
    uint32_t dst = mma::smem_addr(s) + t.at(r_first, c) * 16;
    const uint32_t dst_step = rpi * t.w * 16;
    const bf16* src = X + (r0 + r_first) * ldx + c0 + c * 8;
    const int64_t src_step = rpi * ldx;
#pragma unroll 4
    for (int r = r_first; r < nr; r += rpi) {
      const bool in = c_in && r < r_ok;
      cp_async16_zfill(dst, in ? src : X, in ? 16 : 0);
      dst += dst_step;
      src += src_step;
    }
    return;
  }
  const int cpr = min(t.w, kThreads), rpi = kThreads / cpr;
  const int r_first = threadIdx.x / cpr;
  if (r_first >= rpi) return;
  const int64_t step = rpi * ldx;
  for (int c = threadIdx.x - r_first * cpr; c < t.w; c += cpr) {
    const bf16* src = X + (r0 + r_first) * ldx + c0 + c * 8;
    if (vec) {
      const bool c_in = c * 8 < c_ok;
      for (int r = r_first; r < nr; r += rpi, src += step) {
        bf16* const dst = s + t.at(r, c) * 8;
        if (c_in && r < r_ok)
          gemm::cp_async16(dst, src);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      for (int r = r_first; r < nr; r += rpi, src += step) {
        bf16* const dst = s + t.at(r, c) * 8;
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = r < r_ok && c * 8 + e < c_ok ? src[e]
                                                : __float2bfloat16(0.f);
      }
    }
  }
}

// Walk nk reduction steps `stages` (2 to 4) deep: load(buf, t) stages
// step t into buffer buf, compute(buf) multiplies a staged step.  The
// copy of step t + stages - 1 is issued, all at once, before step t is
// multiplied (spreading it over the k16 steps ran slower); one commit
// group a step (empty past the end), one barrier a step: the buffer a
// load writes was last read in the previous step, before it.
template <class Load, class Compute>
__device__ __forceinline__ void pipeline(int nk, int stages, Load load,
                                         Compute compute) {
  for (int t = 0; t < stages - 1; ++t) {
    if (t < nk) load(t, t);
    gemm::cp_async_commit();
  }
  int use = 0, fill = stages - 1;
  for (int t = 0; t < nk; ++t) {
    if (stages == 4)
      gemm::cp_async_wait<2>();
    else if (stages == 3)
      gemm::cp_async_wait<1>();
    else
      gemm::cp_async_wait<0>();
    __syncthreads();
    if (t + stages - 1 < nk) load(fill, t + stages - 1);
    gemm::cp_async_commit();
    compute(use);
    use = use + 1 == stages ? 0 : use + 1;
    fill = fill + 1 == stages ? 0 : fill + 1;
  }
}

// d[mt][nt] += a[mt] x b[nt] for one k16 step: A fragments of the warp's
// MT m16 tiles from a_at(mt), B fragments of its NT n8 tiles in pairs from
// b_at(j) (registers {0, 1} tile 2j, {2, 3} tile 2j + 1); kTrans: both
// through ldmatrix.trans (reduction-major tiles).  a_at and b_at give the
// lane's shared-memory byte address.
template <int MT, int NT, bool kTrans, class AAt, class BAt>
__device__ __forceinline__ void mma_step(float (&d)[MT][NT][4],
                                         const AAt& a_at, const BAt& b_at) {
  constexpr int NP = (NT + 1) / 2;
  uint32_t b[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (kTrans)
      mma::ldmatrix_x4_trans(b[j], b_at(j));
    else
      mma::ldmatrix_x4(b[j], b_at(j));
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    if (kTrans)
      mma::ldmatrix_x4_trans(a, a_at(mt));
    else
      mma::ldmatrix_x4(a, a_at(mt));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma::mma_bf16_16816(d[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                          b[nt / 2][(nt & 1) * 2 + 1]);
  }
}

// The k16 step of mma_step with A through plain ldmatrix (rows of
// reduction elements, as the NT kernel stages them) and B through
// ldmatrix.trans (reduction-major rows, as the TN kernel stages them): the
// forward GEMM's operands as they lie in memory.  An odd NT's last n8
// tile loads by ldmatrix.x2.trans (b_at gives lanes 0-15 its two
// sub-matrices' rows).
template <int MT, int NT, class AAt, class BAt>
__device__ __forceinline__ void mma_step_ab_t(float (&d)[MT][NT][4],
                                              const AAt& a_at,
                                              const BAt& b_at) {
  constexpr int NP = (NT + 1) / 2;
  uint32_t b[NP][4];
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    if (NT % 2 == 1 && j == NP - 1)
      mma::ldmatrix_x2_trans(b[j][0], b[j][1], b_at(j));
    else
      mma::ldmatrix_x4_trans(b[j], b_at(j));
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    uint32_t a[4];
    mma::ldmatrix_x4(a, a_at(mt));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma::mma_bf16_16816(d[mt][nt], a, b[nt / 2][(nt & 1) * 2],
                          b[nt / 2][(nt & 1) * 2 + 1]);
  }
}

// Store the warp's fragments as bf16: output row (wm MT + mt) 16 + g (+8)
// of the tile, column (wn NT + nt) 8 + 2 (lane % 4) (+1), rows from
// out_row0 of a matrix `ld` columns wide, columns from col0; only rows
// below r_ok and columns below c_ok are written.
template <int MT, int NT>
__device__ __forceinline__ void store(const float (&d)[MT][NT][4],
                                      bf16* out, int64_t ld, int row0,
                                      int col0, int r_ok, int c_ok, int wm,
                                      int wn, int lane) {
  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const bool pairs = ((ld | col0) & 1) == 0;  // 4-byte aligned pairs
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = (wm * MT + mt) * 16 + g + hr * 8;
      if (r >= r_ok) continue;
      bf16* const o = out + (row0 + r) * ld + col0;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = (wn * NT + nt) * 8 + c2;
        const float v0 = d[mt][nt][hr * 2], v1 = d[mt][nt][hr * 2 + 1];
        if (pairs && c + 1 < c_ok) {
          *reinterpret_cast<__nv_bfloat162*>(o + c) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < c_ok) o[c] = __float2bfloat16(v0);
          if (c + 1 < c_ok) o[c + 1] = __float2bfloat16(v1);
        }
      }
    }
  }
}

}  // namespace gemm_mma
