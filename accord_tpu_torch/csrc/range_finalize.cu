// K6: device-side dep finalisation for the range arena, and the dense
// segment compaction under it.
//
// Replaces accord_tpu/ops/kernels.py `range_finalize_csr` (:766, body :799)
// and `_segment_compact` (:473). For each interval entry e (a key
// subject's point interval, or one piece of a range subject's ranges) and
// range row r:
//   stab[e, r] = iv_start[e] < r_end[r] & r_start[r] < iv_end[e]
//                & r_valid[r] & 0 <= iv_of[e] < B & ent_ok[e]
//   bound      = sum of stab (before the witness and before masks)
//   m[e, r]    = stab & witness[subj_kind[o], r_kind] & r_ts < subj_before[o]
//                with o = clip(iv_of[e], 0, B - 1), gathered even for
//                entries the stab masks out
// and the set bits of m, in (entry, row) order, compact to the CSR
// (indptr i32[NV+1], dep_rows i32[out_cap], dep_ts = r_ts[dep_rows]
// i32[out_cap, 3], padding row 0 / r_ts[0] past the total, indptr[NV] past
// out_cap on overflow) with the finalize checksum over the whole arrays.
//
// The JAX kernel materialises the dense [NV, rcap] 0/1 matrix and
// compacts it with a scatter. Here two launches and no memset: one warp
// per (entry, 32-row word) builds the packed word of m with
// `__ballot_sync` (and adds the stab word's popcount to the bound, in the
// compaction's zeroed scratch), then K2's one-launch compaction
// (common.cuh's launch_csr) compacts the packed words, pads, folds the
// checksum and writes the bound: the dense column order is the packed bit
// order, so the outputs are the same.
//
// What bounds it: bytes -- the stab matrix read once as packed words
// (NV x rcap/32) plus the outputs; the compares are a few per (entry, row).
#include "common.cuh"

struct WordsIn {
  const unsigned* words;
  int w;

  __device__ __forceinline__ unsigned word(int, int, long long f,
                                           unsigned* kw) const {
    *kw = 0u;  // the bound is counted when the words are built
    return words[f];
  }
};

// one warp per (entry e, 32-row word wd): the packed word of m, and the
// stab popcount into *bound
__global__ void stab_words_kernel(const int* __restrict__ iv_of,
                                  const int* __restrict__ iv_s,
                                  const int* __restrict__ iv_e,
                                  const unsigned char* __restrict__ ent_ok,
                                  int nv, const int* __restrict__ subj_before,
                                  const int* __restrict__ subj_kinds, int b,
                                  const int* __restrict__ r_start,
                                  const int* __restrict__ r_end,
                                  const int* __restrict__ r_ts,
                                  const int* __restrict__ r_kinds,
                                  const unsigned char* __restrict__ r_valid,
                                  int rcap, const int* __restrict__ witness,
                                  int nk, unsigned* __restrict__ words,
                                  int* __restrict__ bound) {
  const int nwd = rcap >> 5;
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)nv * nwd) return;  // uniform per warp
  const int e = (int)(g / nwd);
  const int wd = (int)(g - (long long)e * nwd);
  const int row = (wd << 5) + lane;
  const int of = iv_of[e];
  const bool inb = of >= 0 && of < b && ent_ok[e] != 0;
  const int o = min(max(of, 0), b - 1);
  const bool stab = inb && iv_s[e] < r_end[row] && r_start[row] < iv_e[e] &&
                    r_valid[row] != 0;
  const unsigned sw = __ballot_sync(0xffffffffu, stab);
  int sk = subj_kinds[o];
  if (sk < 0) sk += nk;                  // a jnp gather: wrap, then clamp
  sk = min(max(sk, 0), nk - 1);
  int rk = r_kinds[row];
  if (rk < 0) rk += nk;
  rk = min(max(rk, 0), nk - 1);
  const bool keep = stab && witness[sk * nk + rk] == 1 &&
                    lex_before(r_ts[row * 3], r_ts[row * 3 + 1],
                               r_ts[row * 3 + 2], subj_before[o * 3],
                               subj_before[o * 3 + 1], subj_before[o * 3 + 2]);
  const unsigned mw = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) {
    words[g] = mw;
    if (sw) atomicAdd(bound, __popc(sw));
  }
}

// _segment_compact over packed rows m[s, w] -> (indptr, dep_rows);
// scratch: kernels.csr_scratch_bytes(1, tiles of s * w words) zeroed
// bytes, left zeroed
extern "C" int segment_compact(const void* m, int s, int w, int out_cap,
                               void* indptr, void* dep_rows, void* scratch,
                               void* stream) {
  WordsIn in{(const unsigned*)m, w};
  return launch_csr(in, s, nullptr, out_cap, (int*)indptr, (int*)dep_rows,
                    nullptr, nullptr, nullptr, scratch,
                    (cudaStream_t)stream);
}

// words: the stab-word scratch u32[nv, rcap/32]; scratch as
// segment_compact's over nv x rcap/32 words
extern "C" int range_finalize_csr(
    const void* iv_of, const void* iv_s, const void* iv_e, const void* ent_ok,
    int nv, const void* subj_before, const void* subj_kinds, int b,
    const void* r_start, const void* r_end, const void* r_ts,
    const void* r_kinds, const void* r_valid, int rcap, const void* witness,
    int nk, int out_cap, void* words, void* indptr, void* dep_rows,
    void* dep_ts, void* bound, void* csum, void* scratch, void* stream) {
  if ((rcap & 31) || b <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long threads = (long long)nv * (rcap >> 5) * 32;
  if (threads > 0) {
    stab_words_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int*)iv_of, (const int*)iv_s, (const int*)iv_e,
        (const unsigned char*)ent_ok, nv, (const int*)subj_before,
        (const int*)subj_kinds, b, (const int*)r_start, (const int*)r_end,
        (const int*)r_ts, (const int*)r_kinds, (const unsigned char*)r_valid,
        rcap, (const int*)witness, nk, (unsigned*)words,
        csr_bound_slot(scratch));
    ACCORD_CHECK();
  }
  WordsIn in{(const unsigned*)words, rcap >> 5};
  return launch_csr(in, nv, (const int*)r_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, scratch, st);
}
