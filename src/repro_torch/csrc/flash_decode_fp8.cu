// Paged flash-decode over an fp8 page pool, for Hopper: the port of
// repro/kernels/flash_decode.py::flash_decode_fp8 (_decode_fp8_kernel,
// pallas_call at :295).
//
// The contract of flash_decode.cu (q (B, Hkv, q_span * G, D), rows
// position-major; block tables; lengths counting the cache including the
// first spanned token; window and logit cap; chunked prefill with
// q_span > 1) with float8_e4m3fn pools (n_pages, page, Hkv, D) and fp32
// per-kv-head scales k_scale, v_scale (Hkv,).  As in the TPU kernel,
// k_scale[h] folds into the score scale (s = q.k * (d^-0.5 * k_scale[h]))
// and v_scale[h] into the output row (sum_j p_j v_j * v_scale[h], applied
// once before the 1 / l normalisation), so no scaled tile is ever
// materialised.
//
// bf16 q: decode_mma.cuh with its KV element type set to fp8, the grid
// and merge of flash_decode.cu (splits x Hkv x B * row tiles, a tile's
// runs one cluster).  The pages are staged as raw bytes (one 16-byte
// cp.async carries 16 e4m3 values, so a ring step costs half the bf16
// bytes of shared memory and the fp8 page the blocking model chooses, the
// "flash_decode_fp8" key, may be twice the bf16 one); each warp widens
// its 16-key chunk's K, then its V, to bf16 in a scratch of its own (e4m3
// is exact in bf16) and runs the bf16 tensor-core step on it.  fp32 q:
// attn_rows.cuh with its KV element type set to fp8, widened in
// registers, on the CUDA cores.  head_dim is any multiple of 16 up to 256
// (a 16-byte chunk of a page row is 16 e4m3 values, so rows are whole
// chunks).
//
// Bound on this card: bytes -- the visible fp8 cache once, half the bf16
// bytes (granite's decode: 3.1 MB, 0.9 us at 3.35 TB/s); the launch and
// one block's serial chain add about 5 us on top.
#include "decode_mma.cuh"

// dtype (of q and the output): 0 = float32, 1 = bfloat16; pools are e4m3
// bytes.  k_scale and v_scale: fp32 (Hkv,).  splits as flash_decode_fwd.
// Returns a cudaError_t.
extern "C" int flash_decode_fp8_fwd(int dtype, int head_dim, const void* q,
                                    const void* k_pages,
                                    const void* v_pages,
                                    const float* k_scale,
                                    const float* v_scale,
                                    const int* block_tables,
                                    const int* lengths, void* o, int batch,
                                    int hkv, int gtot, int q_span, int page,
                                    int n_blocks, int window,
                                    float logit_cap, int splits,
                                    void* stream) {
  if (q_span <= 0 || gtot % q_span || k_scale == nullptr ||
      v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return decode_mma::dispatch<attn::fp8>(
        head_dim, q, k_pages, v_pages, block_tables, lengths, o, k_scale,
        v_scale, batch, hkv, gtot, q_span, page, n_blocks, window,
        logit_cap, splits, s);
  if (dtype != 0 || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{gtot, gtot / q_span, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      head_dim, k_scale, v_scale};
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return attn::launch_rows<float, D, attn::PagedLayout, attn::fp8>(
        lay, hkv, batch, q, k_pages, v_pages, o, mk, page, s);
  });
}
