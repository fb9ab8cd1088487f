// Tensor-core pieces of the bf16 flash-attention kernels: the forward
// (flash_attention.cu) and both backward passes (flash_attention_bwd.cu).
// D is the instance's width (32, 64, 128 or 256; attn_rows.cuh's
// with_head_dim); rows in global memory are the true head_dim (Mask::hd,
// a multiple of 16) apart, and the chunks past it stage as zeros.
//
// Every product is mma.sync m16n8k16 with fp32 sums (mma_frag.cuh).  A
// warp owns one m16 tile of the block's rows (query rows in the forward
// and the dq pass, keys in the dk/dv pass); the streamed operand is a
// tile of whole k16 steps.  The operands live in shared memory as rows
// of D bf16 (256 B at D = 128, a power of two), their 16-byte chunks
// XOR-swizzled by row (chunk c of row r at c ^ (r & 7); at D = 32, four
// chunks a row, at c ^ ((r >> 1) & 3), by the row's 128-byte line), so
// the eight row addresses of each ldmatrix sub-matrix hit eight bank
// groups.  Three
// fragment loads cover every product:
//   ld_a     A of rows m0.. from a row-major [m][D] tile (q, k, v, do);
//   ld_b_nk  B of two n8 tiles from an [n][D] tile (k for q . k^T, q
//            for k . q^T, ...): the tile's D axis is the product's k;
//   ld_b_kn  B of two n8 tiles from a [k][D] tile through ldmatrix.trans
//            (v for p . v, k for ds . k, q and do in the dk/dv pass).
// Scores stay in C fragments: lane l holds rows g = l / 4 and g + 8 of
// its warp's tile, columns 2 (l % 4) and 2 (l % 4) + 1 of each n8 tile,
// so a row's max and sum are two __shfl_xor over the quad.  P and dS go
// from C to A fragments in registers (c_to_a): two neighbouring n8 C
// tiles are one k16 A tile, rounded to bf16 -- the deliberate difference
// from the fp32 products of the TPU kernels and of the plain versions.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attn_rows.cuh"
#include "mma_frag.cuh"

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr int kRowsPerWarp = 16;          // the m16 tile a warp owns
constexpr int kDkvSubRows = 32;           // dk/dv pass: rows scored at once
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Dynamic shared memory of one block (mirrored in
// kernels/flash_attention.py and kernels/flash_attention_bwd.py).
// forward: K and V tiles, two stages [2][K, V][bkv][D]; the q rows
// [bq][D] are staged in stage 1 (they are read into registers before the
// first copy into it) where they fit and D <= 128, else after both
// stages (at D = 256 q is read from shared memory at every tile: its
// fragments would take 64 registers a thread)
template <int D> __host__ __device__ constexpr bool fwd_q_in_regs() {
  return D <= 128;
}
template <int D> constexpr size_t fwd_smem_bytes(int bq, int bkv) {
  return size_t(bq <= 2 * bkv && fwd_q_in_regs<D>() ? 4 * bkv
                                                     : 4 * bkv + bq) *
         D * sizeof(bf16);
}
// dq pass: q and do rows [bq][D], K and V tiles [2][bkv][D], lse, delta
template <int D> constexpr size_t dq_smem_bytes(int bq, int bkv) {
  return size_t(2 * bq + 2 * 2 * bkv) * D * sizeof(bf16) +
         size_t(2) * bq * sizeof(float);
}
// dk/dv pass: k and v rows [bkv][D], q and do tiles [2][bq][D], and the
// tiles' lse and delta [2][bq] each
template <int D> constexpr size_t dkv_smem_bytes(int bq, int bkv) {
  return size_t(2 * 2 * bq + 2 * bkv) * D * sizeof(bf16) +
         size_t(2) * 2 * bq * sizeof(float);
}

// element offset of 16-byte chunk c of row r in a swizzled [rows][D] tile
// (kernels/flash_attention.py::chunk_at)
template <int D> __device__ __forceinline__ int swz(int r, int c) {
  constexpr int CPR = D / 8;
  if constexpr (CPR >= 8) {
    return r * D + ((c ^ (r & 7)) << 3);
  } else {
    return r * D + ((c ^ ((r / (8 / CPR)) & (CPR - 1))) << 3);
  }
}

// x / d for 0 <= x with x * (d - 1) < 2^32 (the launcher checks the
// bound): one multiply-high by the rounded-up reciprocal, where the row
// maps would otherwise divide by a runtime G once per row and element.
struct FastDiv {
  uint32_t d, mul;
  explicit FastDiv(uint32_t d_)
      : d(d_),
        mul(d_ > 1 ? uint32_t(((uint64_t(1) << 32) + d_ - 1) / d_) : 0u) {}
  __device__ __forceinline__ int div(int x) const {
    return d == 1 ? x : int(__umulhi(uint32_t(x), mul));
  }
  static bool exact(int64_t x_max, int d) {
    return x_max * (d - 1) < (int64_t(1) << 32);
  }
};

// Stage rows 0 .. N - 1 of the swizzled [N][D] tile ta from ga, and with
// kPair of tb from gb (K and V, or q and do), row r at element offset
// off(r), its first hc chunks (head_dim / 8), or zeros where off(r) < 0
// and past chunk hc (zeros keep every product finite: a masked p or ds
// is exactly 0, and 0 times a zero row is 0 where 0 times stale bits
// could be NaN).  Thread t copies 16-byte chunk t % (D / 8) of rows
// t / (D / 8), t / (D / 8) + kThreads / (D / 8), ..., so each row's
// offset is computed once for both tiles.
template <int D, int kThreads, int N, bool kPair, class Off>
__device__ __forceinline__ void stage_rows(bf16* ta, const bf16* ga,
                                           bf16* tb, const bf16* gb,
                                           int hc, const Off& off) {
  constexpr int CPR = D / 8, RPI = kThreads / CPR;
  static_assert(kThreads % CPR == 0, "whole rows per pass");
  const int c = threadIdx.x % CPR, r0 = threadIdx.x / CPR;
#pragma unroll
  for (int i = 0; i < (N + RPI - 1) / RPI; ++i) {
    const int r = r0 + i * RPI;
    if (N % RPI != 0 && r >= N) break;
    const int64_t o = c < hc ? off(r) : -1;
    const int e = swz<D>(r, c);
    if (o >= 0) {
      attn::cp_async16(ta + e, ga + o + c * 8);
      if constexpr (kPair) attn::cp_async16(tb + e, gb + o + c * 8);
    } else {
      *reinterpret_cast<uint4*>(ta + e) = make_uint4(0u, 0u, 0u, 0u);
      if constexpr (kPair)
        *reinterpret_cast<uint4*>(tb + e) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// one fp32 from global to shared memory, asynchronously (committed with
// the tile it belongs to)
__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   mma::smem_addr(smem)),
               "l"(gmem));
}

// A (16 x 16) of rows m0 .. m0 + 15, k16 step ks, of an [m][D] tile
template <int D>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int m0, int ks, int lane) {
  mma::ldmatrix_x4(a, mma::smem_addr(
                          tile + swz<D>(m0 + (lane & 15),
                                        2 * ks + (lane >> 4))));
}

// B of n8 tiles n0 (b[0], b[1]) and n0 + 8 (b[2], b[3]) at k16 step ks of
// an [n][D] tile
template <int D>
__device__ __forceinline__ void ld_b_nk(uint32_t (&b)[4], const bf16* tile,
                                        int n0, int ks, int lane) {
  mma::ldmatrix_x4(b, mma::smem_addr(
                          tile + swz<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * ks + ((lane >> 3) & 1))));
}

// B of n8 tiles 2 np (b[0], b[1]) and 2 np + 1 (b[2], b[3]) at k rows
// k0 .. k0 + 15 of a [k][D] tile
template <int D>
__device__ __forceinline__ void ld_b_kn(uint32_t (&b)[4], const bf16* tile,
                                        int k0, int np, int lane) {
  mma::ldmatrix_x4_trans(b, mma::smem_addr(
                                tile + swz<D>(k0 + (lane & 15),
                                              2 * np + (lane >> 4))));
}

// c[NT] += rows m0.. of a ([m][D]) times rows 0 .. 8 NT - 1 of b ([n][D])
// transposed: a 16 x 8NT block of a . b^T, the D axis reduced
template <int D, int NT>
__device__ __forceinline__ void mma_abt(float (&c)[NT][4], const bf16* a,
                                        int m0, const bf16* b, int lane) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs");
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t af[4];
    ld_a<D>(af, a, m0, ks, lane);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bf[4];
      ld_b_nk<D>(bf, b, 16 * n2, ks, lane);
      mma::mma_bf16_16816(c[2 * n2], af, bf[0], bf[1]);
      mma::mma_bf16_16816(c[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// the same with a's fragments already in registers (af[D / 16])
template <int D, int NT>
__device__ __forceinline__ void mma_abt_reg(float (&c)[NT][4],
                                            const uint32_t (&af)[D / 16][4],
                                            const bf16* b, int lane) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      uint32_t bf[4];
      ld_b_nk<D>(bf, b, 16 * n2, ks, lane);
      mma::mma_bf16_16816(c[2 * n2], af[ks], bf[0], bf[1]);
      mma::mma_bf16_16816(c[2 * n2 + 1], af[ks], bf[2], bf[3]);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// C fragments of n8 tiles 2j and 2j + 1 as the bf16 A fragment of k16
// step j (rows g and g + 8, k 2t.. and 8 + 2t..)
template <int NT>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4],
                                       const float (&c)[NT][4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// acc[D / 8] (16 x D) += the k16 A fragment a times rows k0 .. k0 + 15
// of b ([k][D])
template <int D>
__device__ __forceinline__ void mma_ab_step(float (&acc)[D / 8][4],
                                            const uint32_t (&a)[4],
                                            const bf16* b, int k0,
                                            int lane) {
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t bf[4];
    ld_b_kn<D>(bf, b, k0, np, lane);
    mma::mma_bf16_16816(acc[2 * np], a, bf[0], bf[1]);
    mma::mma_bf16_16816(acc[2 * np + 1], a, bf[2], bf[3]);
  }
}

// column of C element e of n8 tile nt, relative to the tile's first
__device__ __forceinline__ int c_col(int nt, int e, int lane) {
  return nt * 8 + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ bool visible(const attn::Mask& mk, int kpos,
                                        int qpos) {
  bool ok = true;
  if (mk.causal) ok = ok && kpos <= qpos;
  if (mk.window > 0) ok = ok && kpos > qpos - mk.window;
  return ok;
}

// Whether every pair of a tile is visible: keys k_first .. k_last (all
// real) against rows at positions qpos_first .. qpos_last (all real).
// Such a tile needs no per-element mask.
__device__ __forceinline__ bool all_visible(const attn::Mask& mk,
                                            int k_first, int k_last,
                                            int qpos_first, int qpos_last) {
  return (!mk.causal || k_last <= qpos_first) &&
         (mk.window <= 0 || k_first > qpos_last - mk.window);
}

// the score of a raw q . k sum: scaled, capped (cap * tanh(s / cap); tc
// gets the tanh, for the backward's 1 - t^2), in natural units
__device__ __forceinline__ float score(const attn::Mask& mk, float dot,
                                       float* tc) {
  const float s = dot * mk.scale;
  if (mk.cap > 0.f) {
    *tc = tanhf(s / mk.cap);
    return mk.cap * *tc;
  }
  *tc = 0.f;
  return s;
}

// 2^x on the SFU (inputs <= 0 here; a result below 2^-126 flushes to 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The online softmax of one tile of scores on C fragments, for the
// thread's rows g (h = 0) and g + 8 (h = 1), in log2 units: a score is
// s * mul, where s holds raw q . k sums (mul = scale * log2 e: a tile with
// no mask and no cap) or masked, capped scores already in log2 units
// (mul = 1, kNegInf where masked).  s becomes p; m and the thread's share
// of l carry across tiles; acc is rescaled where a row's max moved.  The
// TPU kernel's _softmax_update with its NaN guards: a row with nothing
// visible yet (m <= NEG_INF / 2) keeps alpha = 0 and p = 0 (a tile with
// no mask has no such row).
template <int NT, int DT>
__device__ __forceinline__ void softmax_update(float (&s)[NT][4], float mul,
                                               bool masked, float (&m)[2],
                                               float (&l)[2],
                                               float (&acc)[DT][4]) {
  float tmax[2] = {attn::kNegInf, attn::kNegInf};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) tmax[e >> 1] = fmaxf(tmax[e >> 1], s[nt][e]);
  float m_sub[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(tmax[h]) * mul);
    m_sub[h] = m_new <= attn::kNegInf / 2 ? 0.f : m_new;
    alpha[h] = m[h] <= attn::kNegInf / 2
                   ? 0.f
                   : exp2_ftz(fminf(m[h] - m_new, 0.f));
    m[h] = m_new;
  }
  float psum[2] = {0.f, 0.f};
  if (masked) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = s[nt][e] <= attn::kNegInf / 2
                            ? 0.f
                            : exp2_ftz(s[nt][e] - m_sub[h]);
        s[nt][e] = p;
        psum[h] += p;
      }
  } else {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p = exp2_ftz(fmaf(s[nt][e], mul, -m_sub[h]));
        s[nt][e] = p;
        psum[h] += p;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + psum[h];
  if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[dt][e] *= alpha[e >> 1];
  }
}

// Write the thread's share of a 16 x D fp32 accumulator, times `mul`, as
// bf16 pairs: row h (g or g + 8) to out_row[h] (null: not a real row),
// its first hd columns
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           bf16* const (&out_row)[2],
                                           const float (&mul)[2], int hd,
                                           int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (out_row[h] == nullptr) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      if (dt * 8 < hd)
        *reinterpret_cast<__nv_bfloat162*>(out_row[h] +
                                           c_col(dt, 0, lane)) =
            __floats2bfloat162_rn(acc[dt][2 * h] * mul[h],
                                  acc[dt][2 * h + 1] * mul[h]);
  }
}

}  // namespace attn_mma
