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
#include "deps_block.cuh"

// one warp per (interval e, 32-bucket word wd): covered bits OR-ed into
// cov[o, wd] (cov zeroed by the caller)
__global__ void covered_kernel(const int* __restrict__ iv_of,
                               const int* __restrict__ iv_s,
                               const int* __restrict__ iv_e, int nv, int b,
                               int k, unsigned* __restrict__ cov) {
  const int nw = k >> 5;
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)nv * nw) return;  // uniform per warp
  const int e = (int)(g / nw);
  const int wd = (int)(g - (long long)e * nw);
  const int o = norm_index(iv_of[e], b);
  if (o < 0) return;                     // uniform per warp
  const unsigned s = (unsigned)iv_s[e];
  const int width = (int)((unsigned)iv_e[e] - s);  // wrapping int32
  const bool wide = width <= 0 || width >= k;
  const unsigned j = (unsigned)((wd << 5) + lane);
  const bool covered = wide || ((j - s) & (unsigned)(k - 1)) < (unsigned)width;
  const unsigned word = __ballot_sync(0xffffffffu, covered);
  if (lane == 0 && word) atomicOr(&cov[(long long)o * nw + wd], word);
}

// one warp per (interval e, 32-row word wd) of one range block: overlap
// bits OR-ed into anyr[o, off + wd] (that span zeroed by the caller)
__global__ void range_any_kernel(const int* __restrict__ iv_of,
                                 const int* __restrict__ iv_s,
                                 const int* __restrict__ iv_e, int nv, int b,
                                 const int* __restrict__ r_start,
                                 const int* __restrict__ r_end, int rcap,
                                 unsigned* __restrict__ anyr, int stride,
                                 int off) {
  const int words = rcap >> 5;
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)nv * words) return;
  const int e = (int)(g / words);
  const int wd = (int)(g - (long long)e * words);
  const int o = norm_index(iv_of[e], b);
  if (o < 0) return;
  const int row = (wd << 5) + lane;
  const bool hit = iv_s[e] < r_end[row] && r_start[row] < iv_e[e];
  const unsigned word = __ballot_sync(0xffffffffu, hit);
  if (lane == 0 && word) atomicOr(&anyr[(long long)o * stride + off + wd], word);
}

// pass 2, range side: out[s, off + w] = anyr[s, off + w] & the row masks
__global__ void __launch_bounds__(WARPS * 32)
range_mask_kernel(const unsigned* __restrict__ anyr,
                  const int* __restrict__ subj_before,
                  const int* __restrict__ subj_kinds,
                  const int* __restrict__ subj_store,
                  const int* __restrict__ slot_ptr, int b,
                  const int* __restrict__ r_ts,
                  const int* __restrict__ r_kinds,
                  const unsigned char* __restrict__ r_valid, int rcap,
                  const int* __restrict__ witness, int nk,
                  unsigned* __restrict__ out, int stride, int off) {
  __shared__ int s_before[SUBJ_TILE * 3];
  __shared__ int s_kind[SUBJ_TILE];
  __shared__ int s_mine[SUBJ_TILE];
  __shared__ int s_wit[64];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * SUBJ_TILE;
  const int ns = min(SUBJ_TILE, b - s0);
  for (int i = tid; i < ns * 3; i += blockDim.x)
    s_before[i] = subj_before[(long long)s0 * 3 + i];
  const int slot = slot_ptr == nullptr ? 0 : *slot_ptr;
  for (int i = tid; i < ns; i += blockDim.x) {
    int kd = subj_kinds[s0 + i];
    if (kd < 0) kd += nk;                 // a jnp gather: wrap, then clamp
    s_kind[i] = min(max(kd, 0), nk - 1);
    s_mine[i] = subj_store == nullptr ? 1 : (subj_store[s0 + i] == slot);
  }
  for (int i = tid; i < nk * nk; i += blockDim.x) s_wit[i] = witness[i];
  __syncthreads();

  const int lane = tid & 31;
  const int w = blockIdx.x * WARPS + (tid >> 5);
  if (w >= (rcap >> 5)) return;  // no barrier below this point
  const int row = (w << 5) + lane;
  const int t0 = r_ts[row * 3], t1 = r_ts[row * 3 + 1], t2 = r_ts[row * 3 + 2];
  int rk = r_kinds[row];
  if (rk < 0) rk += nk;
  rk = min(max(rk, 0), nk - 1);
  const bool valid = r_valid[row] != 0;
  for (int s = 0; s < ns; ++s) {
    const long long at = (long long)(s0 + s) * stride + off + w;
    const bool hit = valid && s_mine[s] && ((anyr[at] >> lane) & 1u) &&
                     s_wit[s_kind[s] * nk + rk] == 1 &&
                     lex_before(t0, t1, t2, s_before[s * 3],
                                s_before[s * 3 + 1], s_before[s * 3 + 2]);
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) out[at] = word;
  }
}

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
