// Fused QKV projection for Hopper: the port of
// repro/kernels/qkv_fused.py::qkv_fused (_qkv_kernel :63, pallas_call at
// :103).
//
// q = x @ wq, k = x @ wk, v = x @ wv: x (M, K); wq (K, G*Nkv); wk, wv
// (K, Nkv); all row-major, fp32 or bf16.  The tiles (bm, bk, bn) block
// the per-projection width Nkv.  Three instances (this library holds the
// first two; the third is qkv_fused_mma.cu, symbol qkv_fused_mma_fwd,
// built apart so that the two compile in parallel):
// * fp32 ("fma"): as on the TPU, block j owns q columns [j*G*bn,
//   (j+1)*G*bn) and k and v columns [j*bn, (j+1)*bn), so one staged A
//   tile (bm, bk) feeds all three weight streams: one GEMM over a joint
//   tile of (G+2)*bn columns with a column map onto the three source
//   matrices and outputs (QkvMap), on the tile core of matmul_blocked
//   (gemm_tile.cuh), whose accumulator cap (4 columns x 16 rows a
//   thread) applies to the joint width: at G = 4 a bn of 128 makes 768
//   columns, so bm <= 16.  TF32 would break the fp32 tolerances.
// * bf16, M <= 16 ("mma_t") and M > 16 ("mma"): gemm_mma_inst.cuh's
//   tensor-core instances (row 9's) over a segment-major grid
//   (QkvBlocks): each block owns bn columns of ONE projection -- first
//   the ceil(G Nkv / bn) q blocks, then the k blocks, then the v blocks
//   -- and reads its own weight at its own stride.  At granite's decode
//   (Nkv 1024, G 4, bn 32) that is 128 + 32 + 32 = 192 blocks.  The
//   TPU's joint tile saves x's second and third read, but on this card
//   every column block reads x from L2 anyway (64 KB at decode), while
//   (G+2) bn columns a block would cap the decode grid at 64 blocks for
//   mma_t's bn of 16.  No block straddles two projections, so ragged Nkv
//   needs no special case.
// Ragged M, Nkv and K are masked.
//
// Bound on this card: at decode (M = 8) the three weights are read once,
// (G+2) Nkv K bf16, 50.3 MB at granite's shapes: 0.015 ms at 3.35
// TB/s; at M = 512 the operations over the bf16 tensor cores.
#include "gemm_mma_inst.cuh"

namespace {

template <typename T> struct QkvMap {
  const T *wq, *wk, *wv;
  T *q, *k, *v;
  int nkv, groups, bn;  // bn: per-projection columns of the tile
  // tile column c -> (segment 0 q / 1 k / 2 v, global column)
  __device__ void locate(int c, int& seg, int& col) const {
    const int gq = groups * bn;
    if (c < gq) {
      seg = 0;
      col = blockIdx.x * gq + c;
    } else if (c < gq + bn) {
      seg = 1;
      col = blockIdx.x * bn + c - gq;
    } else {
      seg = 2;
      col = blockIdx.x * bn + c - gq - bn;
    }
  }
  __device__ gemm::ColRef<T> b_col(int c) const {
    int seg, col;
    locate(c, seg, col);
    if (seg == 0)
      return {col < groups * nkv ? wq + col : nullptr, groups * nkv};
    return {col < nkv ? (seg == 1 ? wk : wv) + col : nullptr, nkv};
  }
  __device__ void store(int m, int c, float acc) const {
    int seg, col;
    locate(c, seg, col);
    if (seg == 0) {
      if (col < groups * nkv)
        q[int64_t(m) * groups * nkv + col] = gemm::from_f<T>(acc);
    } else if (col < nkv) {
      (seg == 1 ? k : v)[int64_t(m) * nkv + col] = gemm::from_f<T>(acc);
    }
  }
};

int fma_fwd(const void* x, const void* wq, const void* wk, const void* wv,
            void* q, void* k, void* v, int M, int nkv, int K, int groups,
            int bm, int bk, int bn, cudaStream_t stream) {
  const bool vec = gemm::aligned16(x) && gemm::aligned16(wq) &&
                   gemm::aligned16(wk) && gemm::aligned16(wv) &&
                   K % 4 == 0 && nkv % 4 == 0 && bk % 4 == 0 && bn % 4 == 0;
  const QkvMap<float> map{static_cast<const float*>(wq),
                          static_cast<const float*>(wk),
                          static_cast<const float*>(wv),
                          static_cast<float*>(q), static_cast<float*>(k),
                          static_cast<float*>(v), nkv, groups, bn};
  return gemm::run<float, float>(vec, x, map, M, K, bm, bk,
                                 (groups + 2) * bn, (nkv + bn - 1) / bn,
                                 stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA cores; stages must be 2), 1 = bfloat16 with
// M <= 16 (the transposed instance, 2 to 4 stages; M > 16 runs in
// qkv_fused_mma.cu).  bn blocks the per-projection width Nkv.  Returns a
// cudaError_t.
extern "C" int qkv_fused_fwd(int dtype, const void* x, const void* wq,
                             const void* wk, const void* wv, void* q,
                             void* k, void* v, int M, int nkv, int K,
                             int groups, int bm, int bk, int bn, int stages,
                             void* stream) {
  if (M <= 0 || nkv <= 0 || K <= 0 || groups <= 0 || bm <= 0 || bk <= 0 ||
      bn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && stages == 2)
    return fma_fwd(x, wq, wk, wv, q, k, v, M, nkv, K, groups, bm, bk, bn, s);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return mma_inst::run_mma_t(mma_inst::qkv_args(
      x, wq, wk, wv, q, k, v, M, nkv, K, groups, bm, bk, bn, stages, s));
}
