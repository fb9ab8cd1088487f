// Paged flash-decode for Hopper: the port of
// repro/kernels/flash_decode.py::flash_decode (pallas_call at :233).
//
// q (B, Hkv, q_span * G, D), rows position-major (row r is position
// offset r / G); pools (n_pages, page, Hkv, D); block_tables (B, n_blocks)
// int32; lengths (B,) int32 counting the cache including the first
// spanned token.  Row r of request b sees key kpos < lengths[b] + r / G
// (and kpos > lengths[b] - 1 + r / G - window), exactly _block_mask.
// Block-table entries past a request's length point at scratch page 0:
// they are read only when a row can see them.
//
// The TPU grid (B, Hkv, n_blocks) carried m/l/acc across the sequential
// KV axis, one page a step, for the G rows of one (b, kv head).  Here the
// bf16 instance is decode_mma.cuh: the grid is (splits, Hkv, B * row
// tiles), each block one m16 tile of a (b, kv head)'s rows and one
// page-aligned run of the keys they see, the splits of a tile one cluster
// merged through distributed shared memory by their running max and sum;
// the four warps take the run's 16-key chunks in turn out of a ring of
// whole pages (kStages steps of at least 64 keys), score them on the
// tensor cores and multiply P . V with P in a bf16 high part and its
// residual.  The split count (kernels/flash_decode.py::decode_splits) is
// the least whose blocks fill the card: granite's decode at 8 slots runs
// 64 (b, kv head) pairs x 3 splits.  The page the blocking model chooses
// (serve/kv_cache.choose_page_size, priced by decode_smem_bytes) is the
// ring's unit.  The fp32 instance keeps attn_rows.cuh on the CUDA cores
// (one block of 4 rows a (b, kv head), the KV tile one page, two stages):
// TF32 would break its tolerance.
//
// head_dim: any multiple of 16 up to 256, run at the smallest compiled
// width at least it (32, 64, 128, 256).
//
// Bound on this card: bytes -- every visible K/V byte read once (a split
// reads its run only), 0.5 flop/byte at decode, 3.35 TB/s.  At granite's
// decode (1,509 keys over 8 slots, 6.2 MB) that is 1.9 us; a launch and
// the serial chain of one block (lengths and page table, the copies, the
// cluster merge) add about 5 us on top of the bytes.
#include "decode_mma.cuh"

// dtype (of q and the output): 0 = float32, 1 = bfloat16.  splits: the
// bf16 instance's runs per row tile (1 .. 16); the fp32 instance takes 1.
// Returns a cudaError_t.
extern "C" int flash_decode_fwd(int dtype, int head_dim, const void* q,
                                const void* k_pages, const void* v_pages,
                                const int* block_tables, const int* lengths,
                                void* o, int batch, int hkv, int gtot,
                                int q_span, int page, int n_blocks,
                                int window, float logit_cap, int splits,
                                void* stream) {
  if (q_span <= 0 || gtot % q_span)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return decode_mma::dispatch<__nv_bfloat16>(
        head_dim, q, k_pages, v_pages, block_tables, lengths, o, nullptr,
        nullptr, batch, hkv, gtot, q_span, page, n_blocks, window,
        logit_cap, splits, s);
  if (dtype != 0 || splits != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const attn::PagedLayout lay{gtot, gtot / q_span, hkv, page, n_blocks,
                              block_tables, lengths};
  const attn::Mask mk{1, window, 1.0f / sqrtf(float(head_dim)), logit_cap,
                      head_dim};
  return attn::with_head_dim(head_dim, [&](auto d) {
    constexpr int D = decltype(d)::value;
    return attn::launch_rows<float, D>(lay, hkv, batch, q, k_pages, v_pages,
                                       o, mk, page, s);
  });
}
