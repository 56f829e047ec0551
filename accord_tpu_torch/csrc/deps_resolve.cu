// K1: the key-domain deps query, one packed dependency word per
// (subject, 32 arena rows).
//
// Replaces accord_tpu/ops/kernels.py `deps_resolve` (:268) and, with one
// launch per store block writing its own word span, `fused_deps_resolve`
// (:305). The JAX kernel builds f32 subject bitmaps [B, K] and tests
// overlap as a bf16 matmul against the arena's f32 [cap, K] bitmaps (> 0.5).
// Here the arena bitmaps stay PACKED, as [cap, K/32] words: overlap is
// exactly `any(subject_words & row_words)`, which is what the 0/1 product
// counted, and at cap 16384, K 1024 the lane is 2 MB instead of 64 MB.
//
// What bounds it on an H100: the work is the masked word ANDs of B x cap
// (subject, row) pairs on the CUDA cores, and the output, B x cap/32
// words, written once; the packed lane (2 MB at cap 16384, K 1024) and the
// small row lanes are read once per subject tile and mostly come from L2.
// The design: a pre-pass turns the subject CSR into packed subject words
// with atomicOr; then the block body (deps_block.cuh) gives a CTA a tile
// of 64 subjects x 32 row words: it checks ownership before any load,
// compacts each owned subject's words into its nonzero (index, word) list
// in shared memory, lets one warp a 32-row word test the cheap row masks
// first (valid, store slot, witness, lexicographic before) and the AND
// over the subject's nonzero words only (at most 4 for a PreAccept
// subject, where the parent walked all 32), packs the word with
// `__ballot_sync`, stages it in shared memory and writes the tile as
// 16-byte vector stores. A b1 tensor-core form of the overlap (K18's) is
// no faster at this shape: the gain is in what is skipped.
//
// A mesh shard (accord_tpu_torch/parallel/mesh.py, replacing the JAX
// package's parallel/mesh.py `sharded_deps_resolve` :170 and the per-store
// body `_fused_key_resolve_blocks` :329) runs the same two launches on its
// block: `deps_subjects_slice` keeps only the keys of its 'model' bucket
// slice [base, base + k_local) of k_total (normalised over k_total first,
// then tested against the slice, so a negative key wraps as on one
// device), and `deps_block` reads its 'data' rows' word slice of the arena
// in place through the row stride. The 'model' partials are packed words;
// they merge by OR (csrc/mesh_combine.cu), never by a sum. Bound: K1's, on
// the shard's rows x its bucket words; at the burns' sizes a shard's two
// launches and their host work dominate, which the design accepts for a
// first port (one launch over a shard table is the later step).
#include "deps_block.cuh"

// key = norm_index(subj_keys[i], k_total) - base; kept when in [0, k_local)
__global__ void subject_bitmap_kernel(const int* __restrict__ subj_of,
                                      const int* __restrict__ subj_keys,
                                      int nnz, int b, int k_total, int base,
                                      int k_local,
                                      unsigned* __restrict__ subj_words) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nnz) return;
  int s = norm_index(subj_of[i], b);
  int key = norm_index(subj_keys[i], k_total);
  if (s < 0 || key < 0) return;  // CSR padding (subj_of == B) is dropped
  key -= base;
  if (key < 0 || key >= k_local) return;  // another shard's buckets
  atomicOr(&subj_words[(long long)s * (k_local >> 5) + (key >> 5)],
           1u << (key & 31));
}

// Packed subject words [b, k_local/32] of the bucket slice [base, base +
// k_local) of k_total buckets, from the subject CSR (zeroed first).
extern "C" int deps_subjects_slice(const void* subj_of, const void* subj_keys,
                                   int nnz, int b, int k_total, int base,
                                   int k_local, void* subj_words,
                                   void* stream) {
  if ((k_local & 31) || k_local <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(subj_words, 0, (size_t)b * (k_local >> 5) * sizeof(unsigned),
                  st);
  ACCORD_CHECK();
  if (nnz > 0) {
    subject_bitmap_kernel<<<(nnz + 255) / 256, 256, 0, st>>>(
        (const int*)subj_of, (const int*)subj_keys, nnz, b, k_total, base,
        k_local, (unsigned*)subj_words);
    ACCORD_CHECK();
  }
  return 0;
}

// Packed subject words [b, k/32] from the subject CSR (zeroed first).
extern "C" int deps_subjects(const void* subj_of, const void* subj_keys,
                             int nnz, int b, int k, void* subj_words,
                             void* stream) {
  return deps_subjects_slice(subj_of, subj_keys, nnz, b, k, 0, k, subj_words,
                             stream);
}

// One arena block: out[s, out_off + w] for every subject s and row word w.
// subj_store == slot == NULL for the single-store kernel (no slot mask);
// fused, `slot` points at this block's entry of the slots lane. Row r's nw
// bucket words are act_bm[r * bm_stride ...].
extern "C" int deps_block(const void* subj_words, const void* subj_before,
                          const void* subj_kinds, const void* subj_store,
                          const void* slot, int b, const void* act_bm,
                          int bm_stride, const void* act_ts,
                          const void* act_kinds,
                          const void* act_valid, int cap, int nw,
                          const void* witness, int nk, void* out,
                          int out_stride, int out_off, void* stream) {
  return launch_resolve(subj_words, subj_before, subj_kinds, subj_store,
                        slot, nullptr, b, act_bm, bm_stride, act_ts,
                        act_kinds, act_valid, cap, nw, witness, nk, out,
                        out_stride, out_off, (cudaStream_t)stream);
}
