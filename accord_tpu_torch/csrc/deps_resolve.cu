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
// What bounds it on an H100: the work is B * cap * K/32 word ANDs on the
// CUDA cores (1024 * 16384 * 32 = 537M at the PreAccept-batch shape); the
// bytes (the 2 MB packed lane plus the small row lanes) are read once per
// subject tile and mostly come from L2. The design: a pre-pass turns the
// subject CSR into packed subject words with atomicOr; then one warp per
// 32-row word keeps its 32 rows' words in registers (lane i holds row
// 32w + i), walks a tile of subjects whose words sit in shared memory
// (every lane reads the same address: a broadcast), tests the cheap row
// masks first (valid, store slot, witness table, lexicographic before) and
// the bucket AND only where they pass, and `__ballot_sync` yields the
// packed word itself. The bitwise AND-popcount tensor-core path
// (mma .b1) is a later change.
#include "deps_block.cuh"

__global__ void subject_bitmap_kernel(const int* __restrict__ subj_of,
                                      const int* __restrict__ subj_keys,
                                      int nnz, int b, int k, int nw,
                                      unsigned* __restrict__ subj_words) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nnz) return;
  int s = norm_index(subj_of[i], b);
  int key = norm_index(subj_keys[i], k);
  if (s < 0 || key < 0) return;  // CSR padding (subj_of == B) is dropped
  atomicOr(&subj_words[(long long)s * nw + (key >> 5)], 1u << (key & 31));
}

// Packed subject words [b, k/32] from the subject CSR (zeroed first).
extern "C" int deps_subjects(const void* subj_of, const void* subj_keys,
                             int nnz, int b, int k, void* subj_words,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nw = k >> 5;
  cudaMemsetAsync(subj_words, 0, (size_t)b * nw * sizeof(unsigned), st);
  ACCORD_CHECK();
  if (nnz > 0) {
    subject_bitmap_kernel<<<(nnz + 255) / 256, 256, 0, st>>>(
        (const int*)subj_of, (const int*)subj_keys, nnz, b, k, nw,
        (unsigned*)subj_words);
    ACCORD_CHECK();
  }
  return 0;
}

// One arena block: out[s, out_off + w] for every subject s and row word w.
// subj_store == slot == NULL for the single-store kernel (no slot mask);
// fused, `slot` points at this block's entry of the slots lane.
extern "C" int deps_block(const void* subj_words, const void* subj_before,
                          const void* subj_kinds, const void* subj_store,
                          const void* slot, int b, const void* act_bm,
                          const void* act_ts, const void* act_kinds,
                          const void* act_valid, int cap, int nw,
                          const void* witness, int nk, void* out,
                          int out_stride, int out_off, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int words = cap >> 5;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  if (words == 0 || b == 0) return 0;
  resolve_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)subj_words, (const int*)subj_before,
      (const int*)subj_kinds, (const int*)subj_store, (const int*)slot,
      nullptr, b,
      (const unsigned*)act_bm, (const int*)act_ts, (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, out_stride, out_off);
  ACCORD_CHECK();
  return 0;
}
