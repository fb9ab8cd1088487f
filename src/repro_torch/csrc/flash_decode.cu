// Paged flash-decode for Hopper: the port of
// repro/kernels/flash_decode.py::flash_decode (pallas_call at :233).
//
// q (B, Hkv, q_span * G, D), rows position-major (row r is position
// offset r / G); pools (n_pages, page, Hkv, D); block_tables (B, n_blocks)
// int32; lengths (B,) int32 counting the cache including the first
// spanned token.  Row r of request b sees key kpos < lengths[b] + r / G
// (and kpos > lengths[b] - 1 + r / G - window), exactly _block_mask.
//
// The TPU grid (B, Hkv, n_blocks) carried m/l/acc across the sequential
// KV axis, one page per step; here a block owns kWarps rows of one
// (b, kv head), reads block_tables[b, kpos / page] and lengths[b] itself,
// and walks keys only up to what its furthest row can see, one page per
// step: the KV tile of attn_rows.cuh is the page, so the page size the
// blocking model chooses (serve/kv_cache.choose_page_size) is this
// kernel's tile.  Any page from 1 key up to the largest whose two-stage
// tile fits the card's opt-in shared memory launches.  q rows are tiled
// across blocks, so a chunked-prefill span (q_span * G rows) never enters
// the block's footprint.  Block-table entries past a request's length
// point at scratch page 0: they are read only when a row can see them,
// and masked when it cannot.
//
// head_dim: any multiple of 16 up to 256, run at the smallest compiled
// width at least it (attn_rows.cuh: 32, 64, 128, 256).
//
// Bound on this card: every visible K/V byte is read once per block of
// rows -- at decode (one position, 4 rows) that is the whole cache once,
// 0.5 flop/byte, bytes bound at 3.35 TB/s.  The simple design leaves the
// card under-filled at small batch: B * Hkv = 64 blocks per layer at
// max_batch 8 against 132 SMs (split-KV is a later step).
#include "attn_rows.cuh"

extern "C" int flash_decode_fwd(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const int* block_tables, const int* lengths,
                                void* o, int batch, int hkv, int gtot,
                                int q_span, int page, int n_blocks,
                                int window, float logit_cap, void* stream) {
  if (q_span <= 0 || gtot % q_span)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{gtot, gtot / q_span, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      head_dim};
  return attn::dispatch(dtype, lay, hkv, batch, q, k_pages, v_pages, o, mk,
                        page, static_cast<cudaStream_t>(stream));
}
