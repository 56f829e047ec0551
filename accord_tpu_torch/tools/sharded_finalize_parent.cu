// The parents of the sharded finalize's graph stage (csrc/finalize_csr.cu
// fin_shard_tab) and of K22's counts_scan and fragment merge
// (csrc/mesh_combine.cu), kept to time the shipped kernels beside them on
// the same card (tools/sharded_finalize_variants.py: the parent's stage
// runs through these entries in place of the shipped table, and its scan
// and merge are bound in place of the shipped ones, the same C
// signatures). Built only by that tool and by chip_smoke.py, never by
// ops/_ext.py. The scan's parent is one block of CT threads, a slot each,
// walking the slots CT at a time.
//
// The stage's parent, a finalize's chain of graph nodes: a count launch
// over every (data, model) shard's record (after a memset of the bound
// partials), K22's one-block counts_scan, a compaction launch over every
// data shard's record into its fragment (after a memset of every
// fragment), and K22's merge. The merge's parent: a sum kernel, a memset
// of the checksum's partial sums, a pad/fold kernel and a one-thread
// checksum kernel -- four stream operations a call.
#include "common.cuh"

struct PShardFin {
  const unsigned* blk;
  int blk_stride, b;
  const unsigned* kid;
  int kid_stride, kc, wl, base_w;
  const int* slot_subj;
  const int* slot_kid;
  const int* subj_row;

  // masked word wd of slot sl; *kw = the slot's kid word (0 when the slot
  // is out of range)
  __device__ __forceinline__ unsigned word(int sl, int wd,
                                           unsigned* kw) const {
    int subj = slot_subj[sl], kd = slot_kid[sl];
    if (subj < 0 || subj >= b || kd < 0 || kd >= kc) {
      *kw = 0u;
      return 0u;
    }
    unsigned km = kid[(long long)kd * kid_stride + wd];
    *kw = km;
    unsigned v = blk[(long long)subj * blk_stride + wd] & km;
    int r = subj_row[subj];
    if (r >= 0 && (r >> 5) == base_w + wd) v &= ~(1u << (r & 31));
    return v;
  }
};

// the count pass of one shard over its slots blockIdx.x, + gridDim.x, ...
__device__ __forceinline__ void parent_shard_count_body(const PShardFin& f,
                                                        int s,
                                                 int* counts, int* bound,
                                                 int bound_lo, int bound_hi) {
  for (int sl = blockIdx.x; sl < s; sl += gridDim.x) {
    const bool bounds = bound != nullptr && sl >= bound_lo && sl < bound_hi;
    int cnt = 0, kb = 0;
    for (int wd = threadIdx.x; wd < f.wl; wd += CT) {
      unsigned kw;
      cnt += __popc(f.word(sl, wd, &kw));
      kb += __popc(kw);
    }
    int tot_c, tot_k;
    block_excl_scan(cnt, &tot_c);
    block_excl_scan(kb, &tot_k);
    if (threadIdx.x == 0) {
      if (counts != nullptr) counts[sl] = tot_c;
      if (bounds) atomicAdd(bound, tot_k);
    }
  }
}

// the compaction pass of one shard over its slots blockIdx.x, + gridDim.x
__device__ __forceinline__ void parent_shard_compact_body(const PShardFin& f,
                                                          int s,
                                                   const int* seg_base,
                                                   int out_cap, int* frag) {
  for (int sl = blockIdx.x; sl < s; sl += gridDim.x) {
    int carry = seg_base[sl];
    for (int w0 = 0; w0 < f.wl; w0 += CT) {
      const int wd = w0 + threadIdx.x;
      unsigned v = 0u, kw;
      if (wd < f.wl) v = f.word(sl, wd, &kw);
      int tot;
      int pos = carry + block_excl_scan(__popc(v), &tot);
      carry += tot;
      while (v) {
        const int bit = __ffs(v) - 1;
        if (pos >= 0 && pos < out_cap)
          frag[pos] = ((f.base_w + wd) << 5) + bit;
        v &= v - 1u;
        ++pos;
      }
    }
  }
}

// The sharded protocol megakernel's form (accord_tpu_torch/ops/
// tick_graph.py): one record per shard in the graph's parameter block, so
// a replay reads the tick's own packed result, kid table and lanes, and
// one launch covers every shard of a finalize (blockIdx.y the record).
struct PShardFinEnt {
  PShardFin f;
  int* counts;          // the shard's slot counts, or null ('model' > 0)
  int* bound;           // its out-cap bound partial
  const int* seg_base;  // its write bases (the compaction)
  int* frag;            // its fragment (the compaction)
  int bound_lo, bound_hi;
};

extern "C" int shard_fin_bytes() { return (int)sizeof(PShardFinEnt); }

// write the record of these operands (device pointers) to host memory dst
extern "C" int shard_fin_pack(void* dst, const void* blk, int blk_stride,
                              int b, const void* kid, int kid_stride, int kc,
                              int wl, int base_w, const void* slot_subj,
                              const void* slot_kid, const void* subj_row,
                              void* counts, void* bound, int bound_lo,
                              int bound_hi, const void* seg_base,
                              void* frag) {
  PShardFinEnt e;
  e.f = PShardFin{(const unsigned*)blk, blk_stride, b, (const unsigned*)kid,
                 kid_stride, kc, wl, base_w, (const int*)slot_subj,
                 (const int*)slot_kid, (const int*)subj_row};
  e.counts = (int*)counts;
  e.bound = (int*)bound;
  e.seg_base = (const int*)seg_base;
  e.frag = (int*)frag;
  e.bound_lo = bound_lo;
  e.bound_hi = bound_hi;
  *(PShardFinEnt*)dst = e;
  return 0;
}

__global__ void __launch_bounds__(CT)
parent_fin_shard_count_tab_kernel(const PShardFinEnt* __restrict__ tab, int s) {
  const PShardFinEnt e = tab[blockIdx.y];
  parent_shard_count_body(e.f, s, e.counts, e.bound, e.bound_lo, e.bound_hi);
}

__global__ void __launch_bounds__(CT)
parent_fin_shard_compact_tab_kernel(const PShardFinEnt* __restrict__ tab, int s,
                             int out_cap) {
  const PShardFinEnt e = tab[blockIdx.y];
  parent_shard_compact_body(e.f, s, e.seg_base, out_cap, e.frag);
}

static inline int parent_shard_grid(int s) {
  return s < 1 ? 1 : (s > 65535 ? 65535 : s);
}

// fin_shard_count over a table of nent records (device memory) of s slots
// each; the bound partials (nbounds ints at `bounds`) are zeroed first
extern "C" int fin_shard_count_tab(const void* tab, int nent, int s,
                                   void* bounds, int nbounds, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nbounds > 0) {
    cudaMemsetAsync(bounds, 0, sizeof(int) * (size_t)nbounds, st);
    ACCORD_CHECK();
  }
  if (s <= 0 || nent <= 0) return 0;
  if (nent > 65535) return (int)cudaErrorInvalidValue;
  parent_fin_shard_count_tab_kernel<<<dim3(parent_shard_grid(s), nent), CT,
                                      0, st>>>(
      (const PShardFinEnt*)tab, s);
  ACCORD_CHECK();
  return 0;
}

// fin_shard_compact over a table of nent records; the fragments (nfrag
// ints at `frags`, every record's) are zeroed first
extern "C" int fin_shard_compact_tab(const void* tab, int nent, int s,
                                     int out_cap, void* frags, int nfrag,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (nfrag > 0) {
    cudaMemsetAsync(frags, 0, sizeof(int) * (size_t)nfrag, st);
    ACCORD_CHECK();
  }
  if (s <= 0 || nent <= 0 || out_cap <= 0) return 0;
  if (nent > 65535) return (int)cudaErrorInvalidValue;
  parent_fin_shard_compact_tab_kernel<<<dim3(parent_shard_grid(s), nent), CT,
                                        0, st>>>(
      (const PShardFinEnt*)tab, s, out_cap);
  ACCORD_CHECK();
  return 0;
}

// counts [data, s] -> indptr [s+1] (exclusive prefix of the column sums,
// indptr[s] the total), seg_base [data, s] (indptr[i] + the lower shards'
// counts of slot i), bound = the sum of bounds [nb]; wrapping int32, as
// the reference's int32 cumsum
__global__ void __launch_bounds__(CT)
parent_counts_scan_kernel(const int* __restrict__ counts, int data, int s,
                   const int* __restrict__ bounds, int nb,
                   int* __restrict__ indptr, int* __restrict__ seg_base,
                   int* __restrict__ bound) {
  unsigned carry = 0u;
  for (int lo = 0; lo < s; lo += CT) {
    const int i = lo + threadIdx.x;
    unsigned col = 0u;
    if (i < s)
      for (int d = 0; d < data; ++d)
        col += (unsigned)counts[(long long)d * s + i];
    int tot;
    const unsigned ex = carry + (unsigned)block_excl_scan((int)col, &tot);
    if (i < s) {
      indptr[i] = (int)ex;
      unsigned below = 0u;
      for (int d = 0; d < data; ++d) {
        seg_base[(long long)d * s + i] = (int)(ex + below);
        below += (unsigned)counts[(long long)d * s + i];
      }
    }
    carry += (unsigned)tot;
  }
  if (threadIdx.x == 0) {
    indptr[s] = (int)carry;
    unsigned bsum = 0u;
    for (int k = 0; k < nb; ++k) bsum += (unsigned)bounds[k];
    *bound = (int)bsum;
  }
}

extern "C" int counts_scan(const void* counts, int data, int s,
                           const void* bounds, int nb, void* indptr,
                           void* seg_base, void* bound, void* stream) {
  if (data <= 0 || s < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  parent_counts_scan_kernel<<<1, CT, 0, (cudaStream_t)stream>>>(
      (const int*)counts, data, s, (const int*)bounds, nb, (int*)indptr,
      (int*)seg_base, (int*)bound);
  ACCORD_CHECK();
  return 0;
}

// dep_rows[p] = sum_d frags[d][p]; dep_ts[p] = ts[dep_rows[p]] (a jnp
// gather: a negative row wraps once, then clamps)
__global__ void parent_fragment_sum_kernel(const int* __restrict__ frags,
                                           int data,
                                    int out_cap, const int* __restrict__ ts,
                                    int ts_rows, int* __restrict__ dep_rows,
                                    int* __restrict__ dep_ts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < out_cap; p += stride) {
    unsigned v = 0u;
    for (int d = 0; d < data; ++d)
      v += (unsigned)frags[(long long)d * out_cap + p];
    int r = (int)v;
    dep_rows[p] = r;
    if (r < 0) r += ts_rows;
    r = r < 0 ? 0 : (r >= ts_rows ? ts_rows - 1 : r);
    dep_ts[3 * p] = ts[3LL * r];
    dep_ts[3 * p + 1] = ts[3LL * r + 1];
    dep_ts[3 * p + 2] = ts[3LL * r + 2];
  }
}

// pad dep_rows (and dep_ts) past the total -- row 0, ts[0] -- and fold the
// finalize checksum grid-wide: each thread folds the value it reads (below
// the total) or writes (the padding), and each block adds its partial sums
// into acc[0..2] (wrapping u32 adds: the order cannot change the sum)
__global__ void __launch_bounds__(CT)
parent_merge_pad_fold_kernel(int s, const int* __restrict__ ts, int out_cap,
                      const int* __restrict__ indptr,
                      int* __restrict__ dep_rows, int* __restrict__ dep_ts,
                      unsigned* __restrict__ acc) {
  const int total = indptr[s];
  const int start = total < out_cap ? (total < 0 ? 0 : total) : out_cap;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned s1 = 0, s5 = 0, s9 = 0;
  for (long long p = t; p < out_cap; p += stride) {
    int v = 0;
    if (p < start)
      v = dep_rows[p];
    else
      dep_rows[p] = 0;
    s5 += fold_term(v, (unsigned)p, 5u);
  }
  const int pad[3] = {ts[0], ts[1], ts[2]};
  for (long long i = t; i < 3LL * out_cap; i += stride) {
    const int lane = (int)(i % 3);
    int v;
    if (i / 3 < start) {
      v = dep_ts[i];
    } else {
      v = lane == 0 ? pad[0] : (lane == 1 ? pad[1] : pad[2]);
      dep_ts[i] = v;
    }
    s9 += fold_term(v, (unsigned)i, 9u);
  }
  for (long long i = t; i <= s; i += stride)
    s1 += fold_term(indptr[i], (unsigned)i, 1u);
  block_sum3(s1, s5, s9);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], s1);
    atomicAdd(&acc[1], s5);
    atomicAdd(&acc[2], s9);
  }
}

__global__ void parent_merge_csum_kernel(const unsigned* __restrict__ acc,
                                  unsigned* __restrict__ csum) {
  *csum = acc[0] ^ acc[1] ^ acc[2];
}

// frags [data, out_cap] -> dep_rows [out_cap], dep_ts [out_cap, 3] and the
// checksum word over (indptr [s+1], dep_rows, dep_ts); acc: 3 u32 scratch
extern "C" int fragment_merge(const void* frags, int data, int out_cap,
                              const void* ts, int ts_rows, int s,
                              const void* indptr, void* dep_rows,
                              void* dep_ts, void* csum, void* acc,
                              void* stream) {
  if (data <= 0 || out_cap < 0 || ts_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_cap > 0) {
    parent_fragment_sum_kernel<<<grid_for(out_cap, 256), 256, 0, st>>>(
        (const int*)frags, data, out_cap, (const int*)ts, ts_rows,
        (int*)dep_rows, (int*)dep_ts);
    ACCORD_CHECK();
  }
  cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned), st);
  ACCORD_CHECK();
  long long work = 3LL * out_cap > (long long)s + 1 ? 3LL * out_cap : s + 1;
  int g = grid_for(work, CT);
  if (g > 1024) g = 1024;
  parent_merge_pad_fold_kernel<<<g, CT, 0, st>>>(
      s, (const int*)ts, out_cap, (const int*)indptr, (int*)dep_rows,
      (int*)dep_ts, (unsigned*)acc);
  ACCORD_CHECK();
  parent_merge_csum_kernel<<<1, 1, 0, st>>>((const unsigned*)acc,
                                            (unsigned*)csum);
  ACCORD_CHECK();
  return 0;
}
