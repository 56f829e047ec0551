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
// each) and writes out_cap rows. The design: four launches on one stream.
// (1) per-block popcount totals of the masked words (and the bound, by an
// exact int atomicAdd); (2) one block scans the block totals; (3) each
// block recomputes its masked words, scans them in shared memory, and
// writes every set bit at global position p < out_cap straight to
// dep_rows / dep_ts, and indptr at each slot's first word; (4) one block
// pads past the total and folds the checksum (a wrapping u32 sum, so the
// order of the reduction cannot change it).
#include "common.cuh"

#define FT 256          // threads per block
#define FI 4            // passes of FT consecutive words per block
#define FW (FT * FI)    // words per block

struct FinIn {
  const unsigned* packed;
  int b, wt, off;
  const unsigned* kid_rows;
  int kc, w;
  const int* slot_subj;
  const int* slot_kid;
  int s;
  const int* subj_row;
};

// masked word of flat index f = slot * W + word; *kw = the slot's kid word
__device__ __forceinline__ unsigned masked_word(const FinIn& in, long long f,
                                                unsigned* kw) {
  int s = (int)(f / in.w);
  int w = (int)(f - (long long)s * in.w);
  int subj = in.slot_subj[s], kid = in.slot_kid[s];
  if (subj < 0 || subj >= in.b || kid < 0 || kid >= in.kc) {
    *kw = 0u;
    return 0u;
  }
  unsigned km = in.kid_rows[(long long)kid * in.w + w];
  *kw = km;
  unsigned v = in.packed[(long long)subj * in.wt + in.off + w] & km;
  int r = in.subj_row[subj];
  if (r >= 0 && (r >> 5) == w) v &= ~(1u << (r & 31));
  return v;
}

// block-wide exclusive scan of one int per thread; *total = block sum
__device__ __forceinline__ int block_excl_scan(int x, int* total) {
  __shared__ int warp_sums[FT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < FT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < FT / 32) warp_sums[lane] = v;  // inclusive warp prefix
  }
  __syncthreads();
  int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[FT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

__global__ void __launch_bounds__(FT)
fin_count_kernel(FinIn in, long long n, int* __restrict__ block_sums,
                 int* __restrict__ bound) {
  long long base = (long long)blockIdx.x * FW;
  int cnt = 0, kb = 0;
#pragma unroll
  for (int i = 0; i < FI; ++i) {
    long long f = base + (long long)i * FT + threadIdx.x;
    if (f < n) {
      unsigned kw;
      cnt += __popc(masked_word(in, f, &kw));
      kb += __popc(kw);
    }
  }
  int tot_c, tot_k;
  block_excl_scan(cnt, &tot_c);
  block_excl_scan(kb, &tot_k);
  if (threadIdx.x == 0) {
    block_sums[blockIdx.x] = tot_c;
    atomicAdd(bound, tot_k);
  }
}

// one block: exclusive scan of the block totals; indptr[S] = grand total
__global__ void __launch_bounds__(FT)
fin_scan_kernel(const int* __restrict__ block_sums, int nblocks,
                int* __restrict__ block_off, int* __restrict__ indptr_end) {
  int carry = 0;
  for (int lo = 0; lo < nblocks; lo += FT) {
    int i = lo + threadIdx.x;
    int x = i < nblocks ? block_sums[i] : 0;
    int tot;
    int ex = block_excl_scan(x, &tot);
    if (i < nblocks) block_off[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *indptr_end = carry;
}

__global__ void __launch_bounds__(FT)
fin_expand_kernel(FinIn in, long long n, const int* __restrict__ block_off,
                  const int* __restrict__ act_ts, int out_cap,
                  int* __restrict__ indptr, int* __restrict__ dep_rows,
                  int* __restrict__ dep_ts) {
  long long base = (long long)blockIdx.x * FW;
  int carry = block_off[blockIdx.x];
  for (int i = 0; i < FI; ++i) {
    long long f = base + (long long)i * FT + threadIdx.x;
    unsigned v = 0u, kw;
    if (f < n) v = masked_word(in, f, &kw);
    int tot;
    int pos = carry + block_excl_scan(__popc(v), &tot);
    carry += tot;
    if (f >= n) continue;
    int s = (int)(f / in.w);
    int w = (int)(f - (long long)s * in.w);
    if (w == 0) indptr[s] = pos;
    while (v && pos < out_cap) {
      int bit = __ffs(v) - 1;
      int row = (w << 5) + bit;
      dep_rows[pos] = row;
      dep_ts[pos * 3] = act_ts[row * 3];
      dep_ts[pos * 3 + 1] = act_ts[row * 3 + 1];
      dep_ts[pos * 3 + 2] = act_ts[row * 3 + 2];
      v &= v - 1u;
      ++pos;
    }
  }
}

__device__ __forceinline__ unsigned fold_term(int x, unsigned idx,
                                              unsigned seed) {
  unsigned v = (unsigned)x;
  v ^= v >> 16;
  return v * (2u * idx + seed);
}

__device__ __forceinline__ unsigned block_sum_u32(unsigned x) {
  __shared__ unsigned part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  unsigned t = 0;
  if (warp == 0) {
    t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) t += __shfl_down_sync(0xffffffffu, t, d);
  }
  __syncthreads();
  return t;  // valid in thread 0
}

// one block: pad dep_rows / dep_ts past the total, then the checksum
__global__ void __launch_bounds__(1024)
fin_pad_csum_kernel(int s, const int* __restrict__ act_ts, int out_cap,
                    const int* __restrict__ indptr, int* __restrict__ dep_rows,
                    int* __restrict__ dep_ts, unsigned* __restrict__ csum) {
  int total = indptr[s];
  int start = total < out_cap ? (total < 0 ? 0 : total) : out_cap;
  int a0 = act_ts[0], a1 = act_ts[1], a2 = act_ts[2];
  for (int p = start + threadIdx.x; p < out_cap; p += blockDim.x) {
    dep_rows[p] = 0;
    dep_ts[p * 3] = a0;
    dep_ts[p * 3 + 1] = a1;
    dep_ts[p * 3 + 2] = a2;
  }
  __syncthreads();
  unsigned s1 = 0, s5 = 0, s9 = 0;
  for (int i = threadIdx.x; i <= s; i += blockDim.x)
    s1 += fold_term(indptr[i], (unsigned)i, 1u);
  for (int i = threadIdx.x; i < out_cap; i += blockDim.x)
    s5 += fold_term(dep_rows[i], (unsigned)i, 5u);
  for (int i = threadIdx.x; i < 3 * out_cap; i += blockDim.x)
    s9 += fold_term(dep_ts[i], (unsigned)i, 9u);
  s1 = block_sum_u32(s1);
  s5 = block_sum_u32(s5);
  s9 = block_sum_u32(s9);
  if (threadIdx.x == 0) *csum = s1 ^ s5 ^ s9;
}

// block_sums / block_off: scratch of fin_blocks(s * w) ints each
extern "C" int finalize_blocks(long long n) {
  return (int)((n + FW - 1) / FW);
}

extern "C" int finalize_csr(const void* packed, int b, int wt, int off,
                            const void* kid_rows, int kc, int w,
                            const void* slot_subj, const void* slot_kid,
                            int s, const void* subj_row, const void* act_ts,
                            int out_cap, void* indptr, void* dep_rows,
                            void* dep_ts, void* bound, void* csum,
                            void* block_sums, void* block_off, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FinIn in{(const unsigned*)packed, b, wt, off, (const unsigned*)kid_rows,
           kc, w, (const int*)slot_subj, (const int*)slot_kid, s,
           (const int*)subj_row};
  long long n = (long long)s * w;
  int nblocks = finalize_blocks(n);
  cudaMemsetAsync(bound, 0, sizeof(int), st);
  ACCORD_CHECK();
  if (n > 0) {
    fin_count_kernel<<<nblocks, FT, 0, st>>>(in, n, (int*)block_sums,
                                             (int*)bound);
    ACCORD_CHECK();
  }
  fin_scan_kernel<<<1, FT, 0, st>>>((const int*)block_sums, n > 0 ? nblocks : 0,
                                    (int*)block_off, (int*)indptr + s);
  ACCORD_CHECK();
  if (n > 0) {
    fin_expand_kernel<<<nblocks, FT, 0, st>>>(
        in, n, (const int*)block_off, (const int*)act_ts, out_cap,
        (int*)indptr, (int*)dep_rows, (int*)dep_ts);
    ACCORD_CHECK();
  }
  fin_pad_csum_kernel<<<1, 1024, 0, st>>>(s, (const int*)act_ts, out_cap,
                                          (const int*)indptr, (int*)dep_rows,
                                          (int*)dep_ts, (unsigned*)csum);
  ACCORD_CHECK();
  return 0;
}
