// K2: device-side dep finalisation for the key domain.
//
// Replaces accord_tpu/ops/kernels.py `finalize_csr` (:697, body :736) with
// its `_packed_segment_compact` (:501), `_popcount_u32` (:492) and
// `csr_checksum` (:563). For each (subject, key) slot s and row word w of
// the store's span: m[s, w] = packed[subj, off + w] & kid_rows[kid, w], the
// subject's own bit cleared; the set bits of m, in (slot, row) order, are
// the exact dep rows. Output, bit for bit the JAX tuple:
//   indptr  i32[S+1]     exclusive prefix of the slot counts (indptr[S]
//                        may exceed out_cap: the overflow signal)
//   dep_rows i32[out_cap] p-th set bit's row for p < min(total, out_cap),
//                        0 beyond
//   dep_ts  i32[out_cap,3] act_ts[dep_rows[p]] (act_ts[0] in the padding,
//                        as JAX gathers row 0 there)
//   bound   i32          sum of the valid slots' kid-mask popcounts
//   csum    u32          the position-weighted fold of the three arrays
//
// What bounds it: bytes. It reads S*W words of the packed result and of
// the kid table (at the PreAccept-batch shape 4096 slots x 512 words, 8 MB
// each) and writes out_cap rows. The design (common.cuh's launch_csr, which
// K6 shares): launches on one stream.
// (1) per-block popcount totals of the masked words (and the bound, by an
// exact int atomicAdd); (2) one block scans the block totals; (3) each
// block recomputes its masked words, scans them in shared memory, and
// writes every set bit at global position p < out_cap straight to
// dep_rows / dep_ts, and indptr at each slot's first word; (4) the grid
// pads past the total and folds the checksum (wrapping u32 partial sums
// added atomically, so the order of the reduction cannot change it).
#include "common.cuh"

struct FinIn {
  const unsigned* packed;
  int b, wt, off;
  const unsigned* kid_rows;
  int kc, w;
  const int* slot_subj;
  const int* slot_kid;
  int s;
  const int* subj_row;

  // masked word of flat index f = slot * W + word; *kw = the slot's kid
  // word (the bound counts its bits)
  __device__ __forceinline__ unsigned word(long long f, unsigned* kw) const {
    int sl = (int)(f / w);
    int wd = (int)(f - (long long)sl * w);
    int subj = slot_subj[sl], kid = slot_kid[sl];
    if (subj < 0 || subj >= b || kid < 0 || kid >= kc) {
      *kw = 0u;
      return 0u;
    }
    unsigned km = kid_rows[(long long)kid * w + wd];
    *kw = km;
    unsigned v = packed[(long long)subj * wt + off + wd] & km;
    int r = subj_row[subj];
    if (r >= 0 && (r >> 5) == wd) v &= ~(1u << (r & 31));
    return v;
  }
};

// FinIn read from device memory: the protocol megakernel's graph keeps
// one FinIn per finalize spec in its parameter block, so a replay runs
// the spec against the tick's own packed result, kid table and lanes.
struct FinRef {
  const FinIn* in;
  int w;

  __device__ __forceinline__ unsigned word(long long f, unsigned* kw) const {
    return in->word(f, kw);
  }
};

extern "C" int fin_in_bytes() { return (int)sizeof(FinIn); }

// write the FinIn of these operands (device pointers) to host memory `dst`
extern "C" int fin_in_pack(void* dst, const void* packed, int b, int wt,
                           int off, const void* kid_rows, int kc, int w,
                           const void* slot_subj, const void* slot_kid, int s,
                           const void* subj_row) {
  FinIn in{(const unsigned*)packed, b, wt, off, (const unsigned*)kid_rows,
           kc, w, (const int*)slot_subj, (const int*)slot_kid, s,
           (const int*)subj_row};
  *(FinIn*)dst = in;
  return 0;
}

// block_sums / block_off: scratch of finalize_blocks(s * w) ints each;
// acc: 3 more
extern "C" int finalize_blocks(long long n) {
  return compact_blocks_for(n);
}

extern "C" int finalize_csr(const void* packed, int b, int wt, int off,
                            const void* kid_rows, int kc, int w,
                            const void* slot_subj, const void* slot_kid,
                            int s, const void* subj_row, const void* act_ts,
                            int out_cap, void* indptr, void* dep_rows,
                            void* dep_ts, void* bound, void* csum,
                            void* block_sums, void* block_off, void* acc,
                            void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FinIn in{(const unsigned*)packed, b, wt, off, (const unsigned*)kid_rows,
           kc, w, (const int*)slot_subj, (const int*)slot_kid, s,
           (const int*)subj_row};
  cudaMemsetAsync(bound, 0, sizeof(int), st);
  ACCORD_CHECK();
  return launch_csr(in, s, (const int*)act_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, (int*)block_sums, (int*)block_off,
                    (unsigned*)acc, st);
}

// finalize_csr over a FinIn in device memory (`fin`, of w words per slot
// and s slots); act_ts and every output as in finalize_csr
extern "C" int finalize_csr_ref(const void* fin, int w, int s,
                                const void* act_ts, int out_cap, void* indptr,
                                void* dep_rows, void* dep_ts, void* bound,
                                void* csum, void* block_sums, void* block_off,
                                void* acc, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FinRef in{(const FinIn*)fin, w};
  cudaMemsetAsync(bound, 0, sizeof(int), st);
  ACCORD_CHECK();
  return launch_csr(in, s, (const int*)act_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, (int*)block_sums, (int*)block_off,
                    (unsigned*)acc, st);
}
