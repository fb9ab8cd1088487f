// Paged single-token decode with the output projection fused in, for
// Hopper: the port of repro/kernels/flash_decode.py::flash_decode_oproj
// (_decode_oproj_kernel :360, pallas_call at :460).
//
// q (B, Hkv, G, D); pools (n_pages, page, Hkv, D); block_tables
// (B, n_blocks) and lengths (B,) int32, as flash_decode.cu with q_span 1;
// wo (Hkv, G*D, E), the dense (Hq*D, E) projection grouped by kv head.
// out (B, E) = sum over heads h of attn[b, h] (1, G*D) @ wo[h]; the
// attention output never reaches HBM.
//
// The TPU kernel walked the heads of one batch row in order and kept a
// (1, E) fp32 accumulator resident across them, with each head's whole
// (G*D, E) wo slab in VMEM -- so the slabs were read once per batch row.
// Here wo is read once a call (per group of up to kMaxRows batch rows):
//  * the grid is (E / S slices, Hkv x n_chunks): block (s, y) owns
//    columns [s S, s S + S) of the rows of head h = y / n_chunks's slab
//    that belong to its query-head chunk y % n_chunks (below), for every
//    batch row.  The blocks of a (head, chunk)'s slices form thread-block
//    clusters of c blocks (c, the largest divisor of the slice count up
//    to kernels/flash_decode.py::MAX_CLUSTER, is an argument; above 8 the
//    non-portable size is allowed).  S (128 or 256 columns, 1 or 2 a
//    thread) is picked on the host so that the grid's blocks fill the
//    card (granite: 16 slices of 256 x 8 heads, 128 blocks);
//  * attention, once per (batch row, head) and cluster, with the
//    streaming-softmax core of flash_decode (attn_rows.cuh, unchanged;
//    the KV tile is the page).  Where the cluster has at least as many
//    blocks as the group has rows (granite: 16 blocks, 8 rows), each
//    row's visible pages are cut into n = c / rows page-aligned runs and
//    block p runs run p % n of row p / n (a SplitLayout: the run's keys
//    as attn_rows sees a whole row, positions relative to its start, so
//    the masks and tiles hold), keeping its G x head_dim fp32 rows, each
//    normalised by its own sum, and each query row's running max and sum
//    in its shared memory.  After cluster.sync() every block reads the
//    runs from the other blocks' shared memory (map_shared_rank, 16
//    bytes at a time) and merges each row's runs in run order (each
//    weighted by its sum at the common max), so each holds the group's
//    attention rows, laid out [G*hd][RB] (RB = 8 or 16 row slots).  With
//    fewer blocks than rows, block r runs rows r, r + c, ... whole and
//    the others copy them;
//  * the slab: the block streams wo[h][:, its slice] in 16 KB steps of
//    rows through a kStages-deep cp.async ring (48 KB in flight a block)
//    that overlays the attention tiles, and uses each staged element for
//    every batch row: fp32 multiply-adds on the CUDA cores, over the G*hd
//    rows in order, into RB x (S / 128) sums a thread.  On purpose not
//    mma: the TPU kernel multiplies the fp32 attention rows, which the
//    tensor cores would round to bf16, and at 8 rows the FMA rate per
//    staged byte is several times what HBM feeds;
//  * the head sum: each block writes its (rows, S) fp32 partial into the
//    workspace ws (Hkv x n_chunks, B, E); the last block of a slice to
//    arrive (one atomic counter per (group, slice), the only atomic) sums
//    the partials y = 0, 1, ... in that order (head by head, chunk by
//    chunk), writes out in q's dtype and resets the counter to zero.  The
//    order is fixed, so repeats agree bit for bit.  The counters start at
//    zero (the wrapper owns them) and every launch leaves them so.
// head_dim: any multiple of 16 up to 256, at the smallest compiled width
// at least it (attn_rows.cuh); the attention rows are kept at head_dim.
// Wide query groups (glm4-9b's G 16, granite-34b's G 48 at head_dim 128:
// 6,144 fp32 attention rows a batch row) run in head chunks of gc query
// heads (an argument: the most whose rows fit the two-block budget beside
// the ring, a multiple of kWarps where one warp's rows fit, or G where
// all fit, one chunk; recurrentgemma-9b's D 256 at 16 rows: 2 heads;
// kernels/flash_decode.py::oproj_head_chunk): chunk j's blocks run the
// attention of query heads [j gc, j gc + gc), their gather and the slab's
// rows [j gc hd, (j gc + gc) hd) into a partial of their own, so the
// chunks run side by side on the grid and the head sum adds them.  Chunks
// cost no K/V reads, since attn_rows re-reads a row's pages for every
// kWarps query rows anyway.
// Shared memory: max(the attention tiles, the wo ring) + one chunk's
// rows, whatever B (groups of kMaxRows rows), E and Hkv.
//
// Bound on this card: bytes.  wo, Hq * D * E elements, once (granite:
// 33.5 MB, 0.010 ms at 3.35 TB/s), the visible K and V once per cluster,
// and the fp32 workspace (Hkv * n_chunks * B * E * 4 bytes) out and
// back.  What is
// left over the bound is the attention's: its longest row runs page by
// page before the slab can be multiplied.
#include <cooperative_groups.h>

#include "attn_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxRows = 16;         // batch rows of one group
constexpr int kStages = 4;           // wo steps in the ring
constexpr int kStageBytes = 16384;   // one wo step
constexpr int kMaxCluster = 16;      // blocks of a cluster (non-portable)

// row t (of the chunk from query head c0), dim d of batch-row slot
// `slot` of the group: [gc*hd][RB] fp32
struct RowsToSmem {
  float* x;
  int hd, rb, slot, c0;
  __device__ void put(int t, int d, float v) const {
    x[((t - c0) * hd + d) * rb + slot] = v;
  }
};

// one split's rows of the chunk, [gc*hd] fp32, each normalised by its
// own sum
struct PartToSmem {
  float* part;
  int hd, c0;
  __device__ void put(int t, int d, float v) const {
    part[(t - c0) * hd + d] = v;
  }
};

// The keys [start, end) of a decode row as attn_rows sees a whole row:
// positions relative to start, so its causal and window masks and its
// page-aligned tiles hold unchanged; query rows below t_end (the head
// chunk's last), each one's running max and sum to stats [gc][2] (from
// query head c0) for the merge (a whole row, [0, its length), leaves
// them unread).
struct SplitLayout {
  attn::PagedLayout base;
  int start, end;
  float* stats;
  int c0, t_end;
  __host__ __device__ int rows() const { return t_end; }
  __device__ int64_t q_row(int b, int hk, int t) const {
    return base.q_row(b, hk, t);
  }
  __device__ int qpos(int b, int t) const { return base.qpos(b, t) - start; }
  __device__ int kv_len(int) const { return end - start; }
  __device__ int64_t k_row(int b, int hk, int kpos) const {
    return base.k_row(b, hk, kpos + start);
  }
  __device__ void row_stats(int, int, int t, float m, float l) const {
    stats[2 * (t - c0)] = m;
    stats[2 * (t - c0) + 1] = l;
  }
};

__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* g,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(g), "r"(bytes));
}

__device__ __forceinline__ void load_cols(const float* p, float (&f)[1]) {
  f[0] = *p;
}
__device__ __forceinline__ void load_cols(const float* p, float (&f)[2]) {
  const float2 u = *reinterpret_cast<const float2*>(p);
  f[0] = u.x; f[1] = u.y;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&f)[1]) {
  f[0] = __bfloat162float(*p);
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&f)[2]) {
  const unsigned u = *reinterpret_cast<const unsigned*>(p);
  f[0] = __uint_as_float(u << 16);
  f[1] = __uint_as_float(u & 0xffff0000u);
}

// the attention tiles (overlaid by the wo ring) and one head chunk's
// rows (kernels/flash_decode.py::oproj_smem_bytes_required; groups: the
// chunk's query heads)
template <typename T>
__host__ __device__ constexpr size_t tiles_bytes(int page, int D) {
  return attn::smem_bytes<T>(page, D) > size_t(kStages) * kStageBytes
             ? attn::smem_bytes<T>(page, D)
             : size_t(kStages) * kStageBytes;
}
template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int page, int D, int hd,
                                                int groups, int rb) {
  return tiles_bytes<T>(page, D) +
         (size_t(rb + 1) * groups * hd + 2 * groups) * sizeof(float);
}

// RB: row slots of a group (8, or kMaxRows where B > 8).  CPT: columns a
// thread owns, S = kThreads * CPT.  kExact: head_dim is the instance's D,
// a constant to the compiler (the attention's row strides and masks).
template <typename T, int D, int RB, int CPT, bool kExact>
__global__ void __launch_bounds__(attn::kThreads)
decode_oproj_kernel(attn::PagedLayout lay, const T* __restrict__ q,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ wo, T* __restrict__ out,
                    float* __restrict__ ws, unsigned* __restrict__ counters,
                    attn::Mask mk, int batch, int e_dim, int head_chunk) {
  if constexpr (kExact) mk.hd = D;
  constexpr int S = attn::kThreads * CPT;
  constexpr int V = 16 / sizeof(T);                  // elements a copy
  constexpr int KR = kStageBytes / (S * int(sizeof(T)));  // rows a step
  constexpr int CHUNKS = KR * S / V;                 // copies a step
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = static_cast<int>(cluster.num_blocks());
  const int groups = lay.gtot, hd = mk.hd, gc = head_chunk;
  const int n_chunks = (groups + gc - 1) / gc;
  // partial y: head h, query heads [c0, c0 + gn) and the slab's rows
  // [c0 hd, (c0 + gn) hd)
  const int s = blockIdx.x, y = blockIdx.y, h = y / n_chunks;
  const int c0 = (y - h * n_chunks) * gc, gn = min(gc, groups - c0);
  const int n_rows = gn * hd;
  const int e0 = s * S, e_ok = min(S, e_dim - e0);
  T* const ring = reinterpret_cast<T*>(smem);        // [kStages][KR][S]
  float* const x = reinterpret_cast<float*>(
      smem + tiles_bytes<T>(lay.page, D));           // [gc*hd][RB]
  float* const part = x + gc * hd * RB;              // a split's [gc*hd]
  float* const stats = part + gc * hd;               // its [gc][2] m, l
  const T* const w =
      wo + (int64_t(h) * groups + c0) * hd * e_dim + e0;
  const int col = threadIdx.x * CPT;                 // of the slice

  // the slab, KR rows a step, kStages - 1 steps ahead
  const int steps = (n_rows + KR - 1) / KR;
  auto stage = [&](int step) {
    if (step < steps) {
      T* const dst = ring + (step % kStages) * KR * S;
      const int r0 = step * KR;
      for (int i = threadIdx.x; i < CHUNKS; i += attn::kThreads) {
        const int r = i / (S / V), cc = (i - r * (S / V)) * V;
        const bool in = r0 + r < n_rows && cc < e_ok;
        cp_async16_zfill(dst + r * S + cc,
                         in ? w + int64_t(r0 + r) * e_dim + cc : w,
                         in ? 16 : 0);
      }
    }
    attn::cp_async_commit();
  };

  for (int g0 = 0; g0 < batch; g0 += RB) {
    const int rows = min(RB, batch - g0);
    // With at least as many blocks as rows (one), block p < rows *
    // n_split runs split p % n_split of row p / n_split into its part:
    // the row's visible pages in n_split page-aligned runs (n_split = c /
    // rows; at 1, the whole row).  With fewer, block r runs rows r, r +
    // c, ... into its x.
    const bool one = c >= rows;
    const int n_split = one ? c / rows : 1;

    if (!one) {
      for (int r = rank; r < rows; r += c) {
        const SplitLayout whole{lay, 0, lay.lengths[g0 + r], stats, c0,
                                c0 + gn};
        const RowsToSmem sink{x, hd, RB, r, c0};
        for (int t0 = c0; t0 < c0 + gn; t0 += attn::kWarps) {
          attn::attn_rows<T, D>(whole, q, k, v, mk, lay.page, g0 + r, h,
                                t0, smem, sink);
          __syncthreads();  // the tiles may be reused
        }
      }
    } else if (rank < rows * n_split) {
      const int b = g0 + rank / n_split, sp = rank % n_split;
      const int len = lay.lengths[b], page = lay.page;
      const attn::PageRun run = attn::page_run(
          mk.window > 0 ? max(0, len - mk.window) : 0, len, page, n_split,
          sp);
      const int start = run.first * page;
      const SplitLayout split{lay, start,
                              max(start, min(len, run.end * page)), stats,
                              c0, c0 + gn};
      const PartToSmem sink{part, hd, c0};
      for (int t0 = c0; t0 < c0 + gn; t0 += attn::kWarps) {
        attn::attn_rows<T, D>(split, q, k, v, mk, page, b, h, t0, smem,
                              sink);
        __syncthreads();  // the tiles may be reused
      }
    }
    cluster.sync();  // every block's rows (or split) are in its memory
    // every block's copy of the group's rows in its x; slots past the
    // group are zero
    if (one) {
      // slot b: row b's runs from blocks b n_split + j, merged in run
      // order, each weighted by its sum at the common max over the sum
      // of the weights (the weights first, into the free tiles region),
      // then 4 dims at a time, kU loads in flight a thread
      float* const wts = reinterpret_cast<float*>(smem);  // [rows][n][gn]
      for (int i = threadIdx.x; i < rows * gn; i += attn::kThreads) {
        const int b = i / gn, t = i - b * gn;
        float mx = attn::kNegInf, den = 0.f;
        for (int j = 0; j < n_split; ++j) {
          const float2 st = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(stats, b * n_split + j) + 2 * t);
          if (st.y > 0.f) mx = fmaxf(mx, st.x);
        }
        for (int j = 0; j < n_split; ++j) {
          const float2 st = *reinterpret_cast<const float2*>(
              cluster.map_shared_rank(stats, b * n_split + j) + 2 * t);
          const float wt = st.y > 0.f ? st.y * expf(st.x - mx) : 0.f;
          wts[(b * n_split + j) * gn + t] = wt;
          den += wt;
        }
        for (int j = 0; j < n_split; ++j)
          wts[(b * n_split + j) * gn + t] =
              den > 0.f ? wts[(b * n_split + j) * gn + t] / den : 0.f;
      }
      __syncthreads();
      constexpr int kU = 4;
      const int n4 = n_rows / 4, n = RB * n4;
      for (int i0 = threadIdx.x; i0 < n; i0 += attn::kThreads * kU) {
        float4 o[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) o[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int j = 0; j < n_split; ++j) {
          float4 pj[kU];
          float wt[kU];
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const int idx = i0 + u * attn::kThreads, b = idx % RB;
            const int i = (idx / RB) * 4;
            wt[u] = 0.f;
            if (idx < n && b < rows) {
              pj[u] = *reinterpret_cast<const float4*>(
                  cluster.map_shared_rank(part, b * n_split + j) + i);
              wt[u] = wts[(b * n_split + j) * gn + i / hd];
            }
          }
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (wt[u] != 0.f) {
              o[u].x = fmaf(wt[u], pj[u].x, o[u].x);
              o[u].y = fmaf(wt[u], pj[u].y, o[u].y);
              o[u].z = fmaf(wt[u], pj[u].z, o[u].z);
              o[u].w = fmaf(wt[u], pj[u].w, o[u].w);
            }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int idx = i0 + u * attn::kThreads, b = idx % RB;
          const int i = (idx / RB) * 4;
          if (idx < n) {
            x[i * RB + b] = o[u].x;
            x[(i + 1) * RB + b] = o[u].y;
            x[(i + 2) * RB + b] = o[u].z;
            x[(i + 3) * RB + b] = o[u].w;
          }
        }
      }
    } else {
      // slot r from block r % c
      constexpr int U = 8;
      const int n = n_rows * RB;
      for (int i0 = threadIdx.x; i0 < n; i0 += attn::kThreads * U) {
        float got[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = i0 + u * attn::kThreads, slot = i % RB;
          got[u] = i >= n || slot >= rows ? 0.f
                   : slot % c == rank
                       ? x[i]
                       : cluster.map_shared_rank(x, slot % c)[i];
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (i0 + u * attn::kThreads < n)
            x[i0 + u * attn::kThreads] = got[u];
      }
    }
    cluster.sync();  // no block overwrites or leaves rows another reads

    float acc[RB][CPT] = {};
    for (int p = 0; p < kStages - 1; ++p) stage(p);
    for (int step = 0; step < steps; ++step) {
      attn::cp_async_wait<kStages - 2>();
      __syncthreads();  // step landed; step - 1's buffer is free
      stage(step + kStages - 1);
      const T* const tile = ring + (step % kStages) * KR * S + col;
      const float* const xs = x + step * KR * RB;
      const int kr = min(KR, n_rows - step * KR);
#pragma unroll 8  // loads of later rows in flight: 1 warp an SMSP
      for (int r = 0; r < kr; ++r) {
        float wv[CPT];
        load_cols(tile + r * S, wv);
        float xv[RB];
#pragma unroll
        for (int b = 0; b < RB; b += 4) {
          const float4 u =
              *reinterpret_cast<const float4*>(xs + r * RB + b);
          xv[b] = u.x; xv[b + 1] = u.y; xv[b + 2] = u.z; xv[b + 3] = u.w;
        }
#pragma unroll
        for (int b = 0; b < RB; ++b)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[b][j] = fmaf(xv[b], wv[j], acc[b][j]);
      }
    }
    attn::cp_async_wait<0>();
    float* const mine = ws + (int64_t(y) * batch + g0) * e_dim + e0 + col;
#pragma unroll
    for (int b = 0; b < RB; ++b)
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        if (b < rows && col + j < e_ok)
          mine[int64_t(b) * e_dim + j] = acc[b][j];

    // then the slice's head sum by the last block to arrive
    __threadfence();  // this thread's partial is visible before the count
    __syncthreads();  // ... every thread's
    unsigned* const cnt = counters + (g0 / RB) * gridDim.x + s;
    bool last = false;
    if (threadIdx.x == 0) last = atomicAdd(cnt, 1u) == gridDim.y - 1;
    if (__syncthreads_or(last)) {  // every partial of the slice is in ws
      __threadfence();
      // 4 columns a thread, kParts partials' loads in flight at once;
      // the partials are added in order
      constexpr int kParts = 4;
      const int n4 = rows * (e_ok / 4), n_part = int(gridDim.y);
      for (int i = threadIdx.x; i < n4; i += attn::kThreads) {
        const int b = i / (e_ok / 4), e = e0 + (i - b * (e_ok / 4)) * 4;
        const float* src = ws + int64_t(g0 + b) * e_dim + e;
        const int64_t hs = int64_t(batch) * e_dim;   // one partial's
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int p0 = 0; p0 < n_part; p0 += kParts) {
          float4 p[kParts];
#pragma unroll
          for (int j = 0; j < kParts; ++j)
            if (p0 + j < n_part)
              p[j] = __ldcg(reinterpret_cast<const float4*>(
                  src + (p0 + j) * hs));
#pragma unroll
          for (int j = 0; j < kParts; ++j)
            if (p0 + j < n_part) {
              sum.x += p[j].x; sum.y += p[j].y;
              sum.z += p[j].z; sum.w += p[j].w;
            }
        }
        T* const o = out + int64_t(g0 + b) * e_dim + e;
        o[0] = attn::from_f<T>(sum.x);
        o[1] = attn::from_f<T>(sum.y);
        o[2] = attn::from_f<T>(sum.z);
        o[3] = attn::from_f<T>(sum.w);
      }
      if (threadIdx.x == 0) *cnt = 0u;
    }
    __syncthreads();  // the ring is drained before the next group's tiles
  }
}

template <typename T, int D, int RB, int CPT>
int launch(const attn::PagedLayout& lay, int batch, const void* q,
           const void* k, const void* v, const void* wo, void* out,
           float* ws, unsigned* counters, attn::Mask mk, int e_dim,
           int cluster, int head_chunk, cudaStream_t stream) {
  constexpr int S = attn::kThreads * CPT;
  const int n_slices = (e_dim + S - 1) / S;
  if (cluster < 1 || cluster > kMaxCluster || n_slices % cluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T>(lay.page, D, mk.hd, head_chunk, RB);
  const bool exact = mk.hd == D;
  auto kernel = exact ? decode_oproj_kernel<T, D, RB, CPT, true>
                      : decode_oproj_kernel<T, D, RB, CPT, false>;
  // each instance's attributes set once, to the largest footprint seen
  // (the attribute calls are not free on the host)
  static int smem_set[2] = {48 * 1024, 48 * 1024};
  static bool wide_cluster[2] = {false, false};
  if (int(smem) > smem_set[exact]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[exact] = int(smem);
  }
  if (cluster > 8 && !wide_cluster[exact]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
    wide_cluster[exact] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_slices, lay.hkv * ((lay.gtot + head_chunk - 1) /
                                           head_chunk), 1);
  cfg.blockDim = dim3(attn::kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, lay, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(wo),
      static_cast<T*>(out), ws, counters, mk, batch, e_dim, head_chunk);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch(const attn::PagedLayout& lay, int batch, const void* q,
             const void* k, const void* v, const void* wo, void* out,
             float* ws, unsigned* counters, attn::Mask mk, int e_dim,
             int slice, int cluster, int gc, cudaStream_t stream) {
  const bool wide = batch > 8;
  if (slice == attn::kThreads)
    return wide ? launch<T, D, kMaxRows, 1>(lay, batch, q, k, v, wo, out, ws,
                                            counters, mk, e_dim, cluster, gc,
                                            stream)
                : launch<T, D, 8, 1>(lay, batch, q, k, v, wo, out, ws,
                                     counters, mk, e_dim, cluster, gc,
                                     stream);
  if (slice == 2 * attn::kThreads)
    return wide ? launch<T, D, kMaxRows, 2>(lay, batch, q, k, v, wo, out, ws,
                                            counters, mk, e_dim, cluster, gc,
                                            stream)
                : launch<T, D, 8, 2>(lay, batch, q, k, v, wo, out, ws,
                                     counters, mk, e_dim, cluster, gc,
                                     stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  slice: E columns a block owns (128
// or 256); cluster: blocks of one cluster (divides the slice count, at
// most 16); head_chunk: query heads of one partial (1 to groups).  ws:
// an fp32 (Hkv * ceil(groups / head_chunk), B, E) workspace; counters:
// ceil(B / RB) * ceil(E / slice) zeros, left zero.  Returns a
// cudaError_t.
extern "C" int flash_decode_oproj_fwd(int dtype, int head_dim, const void* q,
                                      const void* k_pages,
                                      const void* v_pages,
                                      const int* block_tables,
                                      const int* lengths, const void* wo,
                                      void* out, void* ws, void* counters,
                                      int batch, int hkv, int groups,
                                      int page, int n_blocks, int e_dim,
                                      int slice, int cluster,
                                      int head_chunk, int window,
                                      float logit_cap, void* stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || page <= 0 || e_dim <= 0 ||
      head_chunk < 1 || head_chunk > groups ||
      e_dim % (16 / (dtype ? 2 : 4)) || (dtype != 0 && dtype != 1) ||
      ws == nullptr || counters == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{groups, groups, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      head_dim};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* const w = static_cast<float*>(ws);
  unsigned* const cnt = static_cast<unsigned*>(counters);
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    if (dtype == 0)
      return dispatch<float, D>(lay, batch, q, k_pages, v_pages, wo, out, w,
                                cnt, mk, e_dim, slice, cluster, head_chunk,
                                s);
    return dispatch<__nv_bfloat16, D>(lay, batch, q, k_pages, v_pages, wo,
                                      out, w, cnt, mk, e_dim, slice, cluster,
                                      head_chunk, s);
  });
}
