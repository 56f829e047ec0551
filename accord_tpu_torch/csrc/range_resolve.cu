// K5: the range-overlap deps query, one packed word per (subject, 32 rows)
// of each store's range arena and, for range subjects, of its key arena.
//
// Replaces accord_tpu/ops/kernels.py `range_deps_resolve` (:415) and, with
// one launch sequence per store block writing its own word span,
// `fused_range_deps_resolve` (:367), with its helper `covered_buckets`
// (:344) fused in. Every subject carries a CSR list of half-open int32
// intervals (iv_of, iv_start, iv_end; padding iv_of == B is dropped, a
// negative iv_of counts from the end, as jnp's `.at[]` does).
//
//   range side: row r is a candidate of subject s when some interval of s
//     overlaps it (iv_start < r_end & r_start < iv_end), AND witness, AND
//     the row's ts is before the subject's bound, AND valid (AND, fused,
//     subj_store == this block's slot);
//   key side (range subjects only): the subject's intervals expand to
//     covered buckets -- bucket j is covered by [s, e) iff
//     (j - s) mod K < e - s in wrapping int32, widths <= 0 or >= K cover
//     everything (K a power of two, so the unsigned mask IS the floor mod)
//     -- and row r is a candidate when its packed bucket words meet them,
//     AND witness, before, valid (K1's block kernel, gated by
//     subj_is_range).
//
// The JAX kernel computes [nv, rcap] compares and a max-scatter by iv_of;
// here pass 1 gives one warp per (interval, 32-row word): `__ballot_sync`
// of the overlap, OR-ed into the subject's word with atomicOr, so the
// result does not depend on the order of iv_of. The covered words are built
// the same way, one warp per (interval, 32-bucket word). Pass 2 applies the
// row masks with one warp per 32-row word over a shared-memory tile of
// subjects (K1's layout).
//
// What bounds it on an H100: operations -- 4 compares per (interval, row)
// plus the masked word ANDs of the key side; the lanes are small and sit
// in L2.
#include "range_block.cuh"

// Covered-bucket words cov[b, k/32] of the interval CSR (zeroed first).
extern "C" int range_covered(const void* iv_of, const void* iv_s,
                             const void* iv_e, int nv, int b, int k,
                             void* cov, void* stream) {
  if (k <= 0 || (k & (k - 1)) || (k & 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nw = k >> 5;
  cudaMemsetAsync(cov, 0, (size_t)b * nw * sizeof(unsigned), st);
  ACCORD_CHECK();
  const long long threads = (long long)nv * nw * 32;
  if (threads > 0 && b > 0) {
    covered_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int*)iv_of, (const int*)iv_s, (const int*)iv_e, nv, b, k,
        (unsigned*)cov);
    ACCORD_CHECK();
  }
  return 0;
}

// One range block: its span [off, off + rcap/32) of anyr (scratch) and of
// out, both [b, stride] words. subj_store == slot == NULL for the
// single-store kernel (no slot mask).
extern "C" int range_block(const void* iv_of, const void* iv_s,
                           const void* iv_e, int nv, const void* subj_before,
                           const void* subj_kinds, const void* subj_store,
                           const void* slot, int b, const void* r_start,
                           const void* r_end, const void* r_ts,
                           const void* r_kinds, const void* r_valid, int rcap,
                           const void* witness, int nk, void* anyr, void* out,
                           int stride, int off, void* stream) {
  if (nk * nk > 64 || (rcap & 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = rcap >> 5;
  if (words == 0 || b == 0) return 0;
  cudaMemset2DAsync((unsigned*)anyr + off, (size_t)stride * sizeof(unsigned),
                    0, (size_t)words * sizeof(unsigned), (size_t)b, st);
  ACCORD_CHECK();
  const long long threads = (long long)nv * words * 32;
  if (threads > 0) {
    range_any_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int*)iv_of, (const int*)iv_s, (const int*)iv_e, nv, b,
        (const int*)r_start, (const int*)r_end, rcap, (unsigned*)anyr, stride,
        off);
    ACCORD_CHECK();
  }
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  range_mask_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)anyr, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_store, (const int*)slot, b, (const int*)r_ts,
      (const int*)r_kinds, (const unsigned char*)r_valid, rcap,
      (const int*)witness, nk, (unsigned*)out, stride, off);
  ACCORD_CHECK();
  return 0;
}

// One key block of a range query: K1's block kernel over the covered words,
// gated by subj_is_range (and, fused, by the block's store slot).
extern "C" int range_key_block(const void* cov, const void* subj_before,
                               const void* subj_kinds,
                               const void* subj_is_range,
                               const void* subj_store, const void* slot,
                               int b, const void* act_bm, const void* act_ts,
                               const void* act_kinds, const void* act_valid,
                               int cap, int nw, const void* witness, int nk,
                               void* out, int stride, int off, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = cap >> 5;
  if (words == 0 || b == 0) return 0;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  resolve_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)cov, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_store, (const int*)slot,
      (const unsigned char*)subj_is_range, b, (const unsigned*)act_bm,
      (const int*)act_ts, (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, stride, off);
  ACCORD_CHECK();
  return 0;
}
