// The paged decode core of kernel rows 1 and 2 on the tensor cores: bf16
// q rows against a bf16 (flash_decode.cu) or fp8 e4m3 (flash_decode_fp8.cu)
// page pool.  The fp32 instances keep attn_rows.cuh on the CUDA cores
// (TF32 would break the fp32 tolerances).
//
// Grid (splits, Hkv, B * row tiles); the splits of one (batch row, kv
// head, row tile) form one thread-block cluster.  A block owns one m16
// tile of the (batch row, kv head)'s q_span * G query rows (the G = 4
// decode rows padded to 16; a chunk's rows in whole tiles) and one
// page-aligned run of the keys the tile can see: attn::page_run() cuts the
// visible pages into `splits` runs on the device, from lengths[b] and the
// window, so the host never reads lengths.  decode_splits() in
// kernels/flash_decode.py picks the least split count whose blocks fill
// the card.
//
// A block's four warps share one ring of kStages steps, a step being
// whole pages of at least step_keys(D) keys (one page where the page is
// longer), copied with 16-byte cp.async.  The run's page indices are read
// from block_tables once, kTable at a time, into shared memory beside
// lengths[b] and the q rows, so no copy waits on a load of its own.  The
// warps take the step's 16-key chunks in turn (chunk c to warp c % 4):
// each staged K and V element is read from shared memory once per block,
// whatever the number of query rows.  A warp scores its chunk against
// the tile's 16 rows with mma.sync m16n8k16 (q in registers up to D =
// 128, K through ld_b_nk), keeps its own running max, sum and 16 x D fp32
// accumulator in C fragments (attn_mma.cuh's online softmax, the TPU
// kernel's NaN guards), and multiplies P . V on the tensor cores with P
// split into a bf16 high part and its bf16 residual, two products into
// the same fp32 sums: P keeps about 16 bits, where one bf16 rounding
// would be a new difference from the fp32 products of the TPU kernel.
// An fp8 page is staged raw (16 keys' dims a copy for D = 128) and each
// warp widens its chunk's K, then its V, into a bf16 scratch of its own
// (e4m3 is exact in bf16); k_scale[h] folds into the score scale and
// v_scale[h] into the finished row.
//
// After the ring the warps' states merge in warp order into the block's
// (unnormalised rows, max, sum), overlaid on the drained ring; after
// cluster.sync() every block merges a share of the tile's outputs over
// the cluster's runs in run order through distributed shared memory, each
// weighted by 2^(its max - the common max): a run that saw no key has sum
// 0 and adds nothing.  No atomics: repeats agree bit for bit.
#pragma once

#include <cooperative_groups.h>

#include "attn_mma.cuh"

namespace decode_mma {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;          // query rows of a block: one m16 tile
constexpr int kChunk = 16;         // keys a warp takes at once
constexpr int kStages = 2;         // steps in the ring
constexpr int kTable = 128;        // page indices held at once
constexpr int kMaxCluster = 16;    // splits of one tile (non-portable)
constexpr int kPad = 8;            // floats past D in a merge row

// Keys a step holds at least (four chunks, one a warp; two at D = 256,
// where a step of four would leave no page in the two-block budget), the
// pages it stages, and its rows: whole chunks, the rows past its pages
// zero.  Mirrored in kernels/flash_decode.py.
__host__ __device__ constexpr int step_keys(int D) {
  return D <= 128 ? 4 * kChunk : 2 * kChunk;
}
__host__ __device__ constexpr int step_pages(int D, int page) {
  return page >= step_keys(D) ? 1 : step_keys(D) / page;
}
__host__ __device__ constexpr int step_rows(int D, int page) {
  return (step_pages(D, page) * page + kChunk - 1) / kChunk * kChunk;
}

// Dynamic shared memory of one block (kernels/flash_decode.py::
// decode_smem_bytes): the ring (K and V, kStages steps, in TK) and for fp8
// the warps' bf16 widening scratch (16 keys each), overlaid after the ring
// by the warps' merge rows; then the q tile, the page table and the
// warps' and the block's (max, sum) per row.
template <typename TK>
__host__ __device__ constexpr size_t ring_bytes(int D, int page) {
  return size_t(kStages) * 2 * step_rows(D, page) * D * sizeof(TK) +
         (sizeof(TK) == 1 ? size_t(kWarps) * kChunk * D * sizeof(bf16) : 0);
}
__host__ __device__ constexpr size_t merge_bytes(int D) {
  return size_t(kWarps) * kRows * (D + kPad) * sizeof(float);
}
template <typename TK>
__host__ __device__ constexpr size_t region_bytes(int D, int page) {
  return ring_bytes<TK>(D, page) > merge_bytes(D) ? ring_bytes<TK>(D, page)
                                                  : merge_bytes(D);
}
template <typename TK>
__host__ __device__ constexpr size_t smem_bytes(int D, int page) {
  return region_bytes<TK>(D, page) + size_t(kRows) * D * sizeof(bf16) +
         size_t(kTable) * sizeof(int) +
         size_t(kWarps + 1) * kRows * 2 * sizeof(float);
}

struct Args {
  const bf16* q;             // (B, Hkv, gtot, hd)
  const void* k;             // (n_pages, page, Hkv, hd) in TK
  const void* v;
  bf16* o;                   // q's shape
  const int* block_tables;   // (B, n_blocks)
  const int* lengths;        // (B,)
  const float* k_scale;      // (Hkv,) fp32, or null
  const float* v_scale;
  int hkv, gtot, groups, page, n_blocks, window, hd, row_tiles;
  float scale, cap;
};

// 16 e4m3 bytes as 16 bf16 (two 16-byte chunks), exactly
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t u) {
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(u & 0xffffu), __NV_E4M3)));
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void widen16(const uint4& raw, uint4& lo,
                                        uint4& hi) {
  lo = make_uint4(fp8x2_to_bf16x2(raw.x), fp8x2_to_bf16x2(raw.x >> 16),
                  fp8x2_to_bf16x2(raw.y), fp8x2_to_bf16x2(raw.y >> 16));
  hi = make_uint4(fp8x2_to_bf16x2(raw.z), fp8x2_to_bf16x2(raw.z >> 16),
                  fp8x2_to_bf16x2(raw.w), fp8x2_to_bf16x2(raw.w >> 16));
}

// Rows r0 .. r0 + 15 of a raw fp8 [rows][D] tile into the swizzled bf16
// [16][D] tile w, by one warp
template <int D>
__device__ __forceinline__ void widen_rows(bf16* w, const attn::fp8* raw,
                                           int r0, int lane) {
  constexpr int CPR = D / 16;            // 16-byte fp8 chunks a row
#pragma unroll
  for (int i = lane; i < kChunk * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    uint4 lo, hi;
    widen16(*reinterpret_cast<const uint4*>(raw + (r0 + r) * D + c * 16), lo,
            hi);
    *reinterpret_cast<uint4*>(w + attn_mma::swz<D>(r, 2 * c)) = lo;
    *reinterpret_cast<uint4*>(w + attn_mma::swz<D>(r, 2 * c + 1)) = hi;
  }
}

// C fragments of n8 tiles 2j, 2j + 1 as two bf16 A fragments of k16 step
// j: hi = bf16(p), lo = bf16(p - hi) (the subtraction is exact)
template <int NT>
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c)[NT][4], int j) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float* p = &c[2 * j + (i >> 1)][2 * (i & 1)];
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[0], p[1]);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(p[0] - hf.x, p[1] - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// The kernel and its launch have internal linkage: each library that
// includes this header keeps its own instances and its own
// once-an-instance attribute flags (a static of a template with external
// linkage would be one object across every library loaded).
namespace {

template <int D, typename TK>
__global__ void __launch_bounds__(kThreads)
decode_mma_kernel(const __grid_constant__ Args a) {
  constexpr bool kFp8 = sizeof(TK) == 1;
  constexpr int CPR = D * int(sizeof(TK)) / 16;   // copies a staged row
  constexpr int VEC = 16 / int(sizeof(TK));       // elements a copy
  constexpr int DT = D / 8;                       // n8 tiles of a row
  constexpr bool kQRegs = attn_mma::fwd_q_in_regs<D>();
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int sp = blockIdx.x, n_split = gridDim.x, hk = blockIdx.y;
  const int b = blockIdx.z / a.row_tiles;
  const int t0 = (blockIdx.z - b * a.row_tiles) * kRows;
  const int page = a.page, hd = a.hd, rows = a.gtot;
  const int srows = step_rows(D, page), spages = step_pages(D, page);

  TK* const ring = reinterpret_cast<TK*>(smem);    // [kStages][K, V][srows][D]
  bf16* const widen =                              // [kWarps][16][D] (fp8)
      reinterpret_cast<bf16*>(smem + size_t(kStages) * 2 * srows * D *
                                         sizeof(TK)) + warp * kChunk * D;
  float* const merge = reinterpret_cast<float*>(smem);  // [kWarps][16][D+8]
  bf16* const qs =                                 // [16][D], swizzled
      reinterpret_cast<bf16*>(smem + region_bytes<TK>(D, page));
  int* const table = reinterpret_cast<int*>(qs + kRows * D);  // [kTable]
  float* const wstat = reinterpret_cast<float*>(table + kTable);  // [w][16][2]
  float* const bstat = wstat + kWarps * kRows * 2;               // [16][2]

  // the q tile (rows past the tile's rows and columns past hd zero), the
  // row's length and its first kTable page indices, all in flight at once
  const int64_t row0 = (int64_t(b) * a.hkv + hk) * rows;
  for (int i = tid; i < kRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = i % (D / 8);
    bf16* dst = qs + attn_mma::swz<D>(r, c);
    if (t0 + r < rows && c * 8 < hd)
      attn::cp_async16(dst, a.q + (row0 + t0 + r) * hd + c * 8);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
  attn::cp_async_commit();
  const int* const bt = a.block_tables + int64_t(b) * a.n_blocks;
  for (int i = tid; i < kTable; i += kThreads)
    table[i] = i < a.n_blocks ? bt[i] : 0;
  const int len = a.lengths[b];

  // the keys the tile's rows can see, and this split's pages of them
  const int t_last = min(t0 + kRows, rows) - 1;
  const int k_hi = min(len + t_last / a.groups, a.n_blocks * page);
  const int k_lo =
      a.window > 0 ? max(0, len - 1 + t0 / a.groups - a.window + 1) : 0;
  const attn::PageRun run = attn::page_run(k_lo, k_hi, page, n_split, sp);
  const int n_steps = (run.end - run.first + spages - 1) / spages;
  __syncthreads();  // the page table is visible

  const TK* const kg = static_cast<const TK*>(a.k);
  const TK* const vg = static_cast<const TK*>(a.v);
  int tb = 0;   // the page of table[0]
  // step st's keys into its stage: rows past the run's visible keys zero
  // (a masked p times a zero row stays 0)
  auto issue = [&](int st) {
    if (st < n_steps) {
      const int pg0 = run.first + st * spages;
      const int pg_end = min(run.end, pg0 + spages);
      if (pg_end > tb + kTable) {   // block-uniform; once per kTable pages
        __syncthreads();
        tb = pg0;
        for (int i = tid; i < kTable; i += kThreads)
          table[i] = tb + i < a.n_blocks ? bt[tb + i] : 0;
        __syncthreads();
      }
      TK* const ks = ring + (st % kStages) * 2 * srows * D;
      TK* const vs = ks + srows * D;
      const int key0 = pg0 * page, key_end = min(k_hi, pg_end * page);
      for (int i = tid; i < srows * CPR; i += kThreads) {
        const int j = i / CPR, c = i % CPR, kpos = key0 + j;
        const int e = kFp8 ? j * D + c * VEC : attn_mma::swz<D>(j, c);
        if (kpos < key_end && c * VEC < hd) {
          const int pg = kpos / page;
          const int64_t off =
              ((int64_t(table[pg - tb]) * page + (kpos - pg * page)) *
                   a.hkv + hk) * hd + c * VEC;
          attn::cp_async16(ks + e, kg + off);
          attn::cp_async16(vs + e, vg + off);
        } else {
          *reinterpret_cast<uint4*>(ks + e) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vs + e) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    attn::cp_async_commit();
  };
  for (int st = 0; st < kStages; ++st) issue(st);

  // the lane's rows g and g + 8 of the tile: their positions (a row past
  // the tile's rows sees nothing)
  const int g = lane >> 2, tq = lane & 3;
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qpos[h] = t0 + g + 8 * h < rows ? len - 1 + (t0 + g + 8 * h) / a.groups
                                    : -1;
  const float s_scale =
      a.scale * (a.k_scale != nullptr ? a.k_scale[hk] : 1.f);
  float m[2] = {attn::kNegInf, attn::kNegInf}, l[2] = {0.f, 0.f};
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
  uint32_t qf[kQRegs ? D / 16 : 1][4];

  for (int st = 0; st < n_steps; ++st) {
    attn::cp_async_wait<kStages - 1>();
    __syncthreads();  // step st (and q) landed for every thread
    if constexpr (kQRegs) {
      if (st == 0) {
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          attn_mma::ld_a<D>(qf[ks], qs, 0, ks, lane);
      }
    }
    const TK* const ks_st = ring + (st % kStages) * 2 * srows * D;
    const TK* const vs_st = ks_st + srows * D;
    const int key0 = (run.first + st * spages) * page;
    const int n_keys =
        min(k_hi, min(run.end, run.first + (st + 1) * spages) * page) - key0;
    for (int ch = warp; ch * kChunk < n_keys; ch += kWarps) {
      const bf16 *kt, *vt;
      if constexpr (kFp8) {
        widen_rows<D>(widen, ks_st, ch * kChunk, lane);
        __syncwarp();
        kt = vt = widen;
      } else {
        kt = ks_st + ch * kChunk * D;
        vt = vs_st + ch * kChunk * D;
      }
      float sc[2][4] = {};
      if constexpr (kQRegs)
        attn_mma::mma_abt_reg<D, 2>(sc, qf, kt, lane);
      else
        attn_mma::mma_abt<D, 2>(sc, qs, 0, kt, lane);
      // scaled, capped, masked scores in log2 units
      const int kc = key0 + ch * kChunk, k_end = key0 + n_keys;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = kc + attn_mma::c_col(nt, e, lane);
          const int qp = qpos[e >> 1];
          const bool ok = kpos < k_end && kpos <= qp &&
                          (a.window <= 0 || kpos > qp - a.window);
          float x = sc[nt][e] * s_scale;
          if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
          sc[nt][e] = ok ? x * attn_mma::kLog2e : attn::kNegInf;
        }
      attn_mma::softmax_update<2, DT>(sc, 1.f, true, m, l, acc);
      uint32_t ph[4], pl[4];
      c_to_a_split<2>(ph, pl, sc, 0);
      if constexpr (kFp8) {
        __syncwarp();   // every lane's K fragments are loaded
        widen_rows<D>(widen, vs_st, ch * kChunk, lane);
        __syncwarp();
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        attn_mma::ld_b_kn<D>(vf, vt, 0, np, lane);
        mma::mma_bf16_16816(acc[2 * np], ph, vf[0], vf[1]);
        mma::mma_bf16_16816(acc[2 * np + 1], ph, vf[2], vf[3]);
        mma::mma_bf16_16816(acc[2 * np], pl, vf[0], vf[1]);
        mma::mma_bf16_16816(acc[2 * np + 1], pl, vf[2], vf[3]);
      }
      if constexpr (kFp8) __syncwarp();   // the scratch may be overwritten
    }
    // every warp is done with step st's stage before a later step
    // refills it (block-uniform); a group is committed either way, so
    // the wait above always leaves exactly the kStages - 1 newest pending
    if (st + kStages < n_steps) __syncthreads();
    issue(st + kStages);
  }
  attn::cp_async_wait<0>();
  __syncthreads();  // the ring is drained: the merge rows overlay it

  // each warp's rows, max and sum; then the block's rows, the warps in
  // warp order, each weighted by 2^(its max - the block's)
  const int nr = min(kRows, rows - t0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lsum = attn_mma::quad_sum(l[h]);
    const int r = g + 8 * h;
    if (r < nr) {
      float* const orow = merge + (warp * kRows + r) * (D + kPad);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        if (dt * 8 < hd)
          *reinterpret_cast<float2*>(orow + attn_mma::c_col(dt, 0, lane)) =
              make_float2(acc[dt][2 * h], acc[dt][2 * h + 1]);
      if (tq == 0) {
        wstat[(warp * kRows + r) * 2] = m[h];
        wstat[(warp * kRows + r) * 2 + 1] = lsum;
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < nr * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    float mx = attn::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (wstat[(w * kRows + r) * 2 + 1] > 0.f)
        mx = fmaxf(mx, wstat[(w * kRows + r) * 2]);
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float lw = wstat[(w * kRows + r) * 2 + 1];
      if (lw > 0.f) {
        const float wt = exp2f(wstat[(w * kRows + r) * 2] - mx);
        o = fmaf(wt, merge[(w * kRows + r) * (D + kPad) + d], o);
        den = fmaf(wt, lw, den);
      }
    }
    merge[r * (D + kPad) + d] = o;   // warp 0's slot: read above by this thread
    if (d == 0) {
      bstat[2 * r] = mx;
      bstat[2 * r + 1] = den;
    }
  }
  if (n_split > 1) cluster.sync();  // every run's rows are in its block
  else __syncthreads();

  // this block's share of the tile's outputs: each output's runs in run
  // order, their (max, sum) and rows loaded together through
  // distributed shared memory, each weighted by 2^(its max - the max)
  const float v_scale = a.v_scale != nullptr ? a.v_scale[hk] : 1.f;
  for (int i = sp * kThreads + tid; i < nr * hd; i += n_split * kThreads) {
    const int r = i / hd, d = i - r * hd;
    float2 st[kMaxCluster];
    float v[kMaxCluster];
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < n_split) {
        st[j] = *reinterpret_cast<const float2*>(
            cluster.map_shared_rank(bstat, j) + 2 * r);
        v[j] = cluster.map_shared_rank(merge, j)[r * (D + kPad) + d];
      }
    float mx = attn::kNegInf;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < n_split && st[j].y > 0.f) mx = fmaxf(mx, st[j].x);
    float o = 0.f, den = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCluster; ++j)
      if (j < n_split && st[j].y > 0.f) {
        const float wt = exp2f(st[j].x - mx);
        o = fmaf(wt, v[j], o);
        den = fmaf(wt, st[j].y, den);
      }
    a.o[(row0 + t0 + r) * hd + d] =
        __float2bfloat16(den > 0.f ? o * v_scale / den : 0.f);
  }
  // no block leaves while another may still read its rows, nor before
  // its own remote loads are complete (those of empty runs, loaded but
  // never used, included): the release arrive orders them
  if (n_split > 1) cluster.sync();
}

template <int D, typename TK>
int launch(const Args& a, int batch, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > kMaxCluster || a.page < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<TK>(D, a.page);
  auto kernel = decode_mma_kernel<D, TK>;
  // the attributes set once an instance, to the largest footprint seen
  static int smem_set = 48 * 1024;
  static bool wide_cluster = false;
  if (int(smem) > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = int(smem);
  }
  if (splits > 8 && !wide_cluster) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_cluster = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, a.hkv, batch * a.row_tiles);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// bf16 q rows against pages in TK (bf16, or fp8 with k_scale and
// v_scale); q_span * G = gtot rows a (batch row, kv head).  Returns a
// cudaError_t.
template <typename TK>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const int* block_tables, const int* lengths, void* o,
             const float* k_scale, const float* v_scale, int batch, int hkv,
             int gtot, int q_span, int page, int n_blocks, int window,
             float logit_cap, int splits, cudaStream_t stream) {
  if (q_span <= 0 || gtot <= 0 || gtot % q_span || hkv <= 0 || batch < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  Args a{static_cast<const bf16*>(q), k, v, static_cast<bf16*>(o),
         block_tables, lengths, k_scale, v_scale, hkv, gtot, gtot / q_span,
         page, n_blocks, window, head_dim, (gtot + kRows - 1) / kRows,
         1.0f / sqrtf(float(head_dim)), logit_cap};
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return launch<D, TK>(a, batch, splits, stream);
  });
}

}  // namespace
}  // namespace decode_mma
