// Fused QKV projection for Hopper: the port of
// repro/kernels/qkv_fused.py::qkv_fused (_qkv_kernel :63, pallas_call at
// :103).
//
// q = x @ wq, k = x @ wk, v = x @ wv in one pass over x: x (M, K);
// wq (K, G*Nkv); wk, wv (K, Nkv); all row-major, fp32 or bf16.  As on the
// TPU, block j of the grid owns q columns [j*G*bn, (j+1)*G*bn) and k and v
// columns [j*bn, (j+1)*bn), so one staged A tile (bm, bk) feeds all three
// weight streams.  Here that is one GEMM over a joint tile of (G+2)*bn
// columns with a column map onto the three source matrices and the three
// outputs (QkvMap), so the tile core of matmul_blocked and matmul_fused
// (gemm_tile.cuh) runs it unchanged.  The accumulator cap of that core
// (one group of 4 columns per thread, at most 16 rows) applies to the
// joint width: at G = 4 a bn of 128 makes 768 columns, one thread-row,
// so bm <= 16; the Hopper adapter and the wrapper refuse wider tiles.
// Ragged M, Nkv and K are masked.
//
// Bound on this card: at decode (M = 8) the three weights are read once,
// bytes bound at 3.35 TB/s; what fusion saves is x's second and third
// read, which matters at the join and chunk shapes (M >= 64).
#include "gemm_tile.cuh"

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

template <typename T>
int dispatch(const void* x, const void* wq, const void* wk, const void* wv,
             void* q, void* k, void* v, int M, int nkv, int K, int groups,
             int bm, int bk, int bn, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = gemm::aligned16(x) && gemm::aligned16(wq) &&
                   gemm::aligned16(wk) && gemm::aligned16(wv) &&
                   K % V == 0 && nkv % V == 0 && bk % V == 0 && bn % V == 0;
  const QkvMap<T> map{static_cast<const T*>(wq), static_cast<const T*>(wk),
                      static_cast<const T*>(wv), static_cast<T*>(q),
                      static_cast<T*>(k), static_cast<T*>(v), nkv, groups,
                      bn};
  return gemm::run<T, T>(vec, x, map, M, K, bm, bk, (groups + 2) * bn,
                      (nkv + bn - 1) / bn, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bn blocks the per-projection width
// Nkv.  Returns a cudaError_t.
extern "C" int qkv_fused_fwd(int dtype, const void* x, const void* wq,
                             const void* wk, const void* wv, void* q,
                             void* k, void* v, int M, int nkv, int K,
                             int groups, int bm, int bk, int bn,
                             void* stream) {
  if (nkv <= 0 || groups <= 0 || bn <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, wq, wk, wv, q, k, v, M, nkv, K, groups, bm,
                           bk, bn, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, wq, wk, wv, q, k, v, M, nkv, K,
                                   groups, bm, bk, bn, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
