// Paged flash-decode over an fp8 page pool, for Hopper: the port of
// repro/kernels/flash_decode.py::flash_decode_fp8 (_decode_fp8_kernel,
// pallas_call at :295).
//
// The contract of flash_decode.cu (q (B, Hkv, q_span * G, D), rows
// position-major; block tables; lengths counting the cache including the
// first spanned token; window and logit cap; chunked prefill with
// q_span > 1) with float8_e4m3fn pools (n_pages, page, Hkv, D) and fp32
// per-kv-head scales k_scale, v_scale (Hkv,).  The pages are staged as raw
// bytes: one 16-byte cp.async carries 16 e4m3 values, so a page of P keys
// costs P * D bytes of shared memory per K or V tile against 2 * P * D in
// bf16 -- the fp8 page the blocking model chooses ("flash_decode_fp8"
// key) may be about twice the bf16 one.  They are widened in registers
// (__nv_cvt_fp8x2_to_halfraw2; e4m3 is exact in fp16).  As in the TPU
// kernel, k_scale[h] folds into the score scale (s = q.k * (d^-0.5 *
// k_scale[h])) and v_scale[h] into the output row (sum_j p_j v_j *
// v_scale[h], applied once before the 1 / l normalisation), so no
// widened tile is ever materialised.  The core is attn_rows.cuh with its
// KV element type set to fp8.
//
// Bound on this card: every visible KV byte is read once per block of
// rows -- at decode (one position, 4 rows of a block) the whole fp8
// cache once, half the bf16 bytes: bytes bound at 3.35 TB/s.  As
// flash_decode, the card is under-filled at small batch (B * Hkv blocks
// per layer; split-KV is a later step).
#include "attn_rows.cuh"

// dtype (of q and the output): 0 = float32, 1 = bfloat16; pools are e4m3
// bytes.  k_scale and v_scale: fp32 (Hkv,).  Returns a cudaError_t.
extern "C" int flash_decode_fp8_fwd(int dtype, int head_dim, const void* q,
                                    const void* k_pages,
                                    const void* v_pages,
                                    const float* k_scale,
                                    const float* v_scale,
                                    const int* block_tables,
                                    const int* lengths, void* o, int batch,
                                    int hkv, int gtot, int q_span, int page,
                                    int n_blocks, int window,
                                    float logit_cap, void* stream) {
  if (q_span <= 0 || gtot % q_span || k_scale == nullptr ||
      v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{gtot, gtot / q_span, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      k_scale, v_scale};
  return attn::dispatch<true>(dtype, head_dim, lay, hkv, batch, q, k_pages,
                              v_pages, o, mk, page,
                              static_cast<cudaStream_t>(stream));
}
