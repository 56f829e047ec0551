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
// Design: common.cuh's launch_csr, ONE launch a call and no memset -- the
// masked words are popcounted, scanned within a tile, offset by decoupled
// look-back over the earlier tiles, expanded straight to dep_rows / dep_ts
// and folded into the checksum by whoever writes them; pad tiles write
// past the total; the last block writes the checksum and the bound and
// leaves the scratch zeroed. `finalize_csr_tab` runs MANY finalizes in that
// one launch, over a table of FinEnt records in device memory (each a
// FinIn and its outputs and scratch): the protocol megakernel's graph
// holds its tick's key finalizes in one such node, the table in its
// parameter block.
//
// What bounds it: bytes. It reads S*W words of the packed result and of
// the kid table (at the PreAccept-batch shape 4096 slots x 512 words, 8 MB
// each) and writes out_cap rows. At a burn's shapes (a few thousand words)
// a call is one launch's latency: the tiles' scans and one look-back.
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

  // masked word wd of slot sl; *kw = the slot's kid word (the bound
  // counts its bits)
  __device__ __forceinline__ unsigned word(int sl, int wd, long long,
                                           unsigned* kw) const {
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

// scratch: kernels.csr_scratch_bytes(1, tiles of s * w words) zeroed bytes
// (the wrapper's pool), left zeroed
extern "C" int finalize_csr(const void* packed, int b, int wt, int off,
                            const void* kid_rows, int kc, int w,
                            const void* slot_subj, const void* slot_kid,
                            int s, const void* subj_row, const void* act_ts,
                            int out_cap, void* indptr, void* dep_rows,
                            void* dep_ts, void* bound, void* csum,
                            void* scratch, void* stream) {
  FinIn in{(const unsigned*)packed, b, wt, off, (const unsigned*)kid_rows,
           kc, w, (const int*)slot_subj, (const int*)slot_kid, s,
           (const int*)subj_row};
  return launch_csr(in, s, (const int*)act_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, scratch, (cudaStream_t)stream);
}

// One finalize of a table: its FinIn (device memory) and its CsrOut.
struct FinEnt {
  const FinIn* in;
  CsrOut o;
};

// the table launch's specs: tile ids in order -- every spec's compaction
// tiles, then every spec's pad tiles (pad0 strictly increasing)
struct FinTab {
  const FinEnt* ents;
  int tiles, nspec, ctiles;
  unsigned long long* state;

  // the spec of tile g: the last whose first tile of g's kind is <= g
  // (a spec with no words has no compaction tile and shares its tile0)
  __device__ __forceinline__ int locate(int g) const {
    const bool pad = g >= ctiles;
    int lo = 0, hi = nspec - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      const int first = pad ? ents[mid].o.pad0 : ents[mid].o.tile0;
      if (first <= g)
        lo = mid;
      else
        hi = mid - 1;
    }
    return lo;
  }
  __device__ __forceinline__ CsrOut out(int k) const { return ents[k].o; }
  __device__ __forceinline__ FinIn src(int k) const { return *ents[k].in; }
};

extern "C" int fin_ent_bytes() { return (int)sizeof(FinEnt); }

// write the FinEnt of one finalize to host memory `dst`: `fin` the device
// address of its FinIn (s slots of w words), act_ts and its five outputs
// as finalize_csr's, `scratch` the table launch's scratch, k the spec's
// index and tile0 / pad0 its first compaction and pad tile (the caller
// numbers them: every spec's csr_tiles_for(s * w) compaction tiles in
// order, then every spec's csr_pads_for(out_cap) pad tiles)
extern "C" int fin_ent_pack(void* dst, const void* fin, int s, int w,
                            const void* act_ts, int out_cap, void* indptr,
                            void* dep_rows, void* dep_ts, void* bound,
                            void* csum, void* scratch, int nspec, int k,
                            int tile0, int pad0) {
  FinEnt e;
  e.in = (const FinIn*)fin;
  e.o = csr_out_one(s, w, (const int*)act_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, scratch, FoldSeeds{1u, 5u, 9u});
  char* base = (char*)scratch;
  e.o.acc = (CsrAcc*)(base + sizeof(CsrHdr)) + k;
  e.o.state = (unsigned long long*)(base + sizeof(CsrHdr) +
                                    sizeof(CsrAcc) * (size_t)nspec) +
              tile0;
  e.o.tile0 = tile0;
  e.o.pad0 = pad0;
  *(FinEnt*)dst = e;
  return 0;
}

// nspec finalizes in ONE launch over the FinEnt table `tab` (device
// memory) of `tiles` tiles in all, `ctiles` of them compaction tiles;
// scratch: kernels.csr_scratch_bytes(nspec, ctiles) zeroed bytes, left
// zeroed
extern "C" int finalize_csr_tab(const void* tab, int nspec, int tiles,
                                int ctiles, void* scratch, void* stream) {
  if (nspec <= 0) return 0;
  if (tiles < nspec || ctiles < 0) return (int)cudaErrorInvalidValue;
  FinTab t;
  t.ents = (const FinEnt*)tab;
  t.tiles = tiles;
  t.nspec = nspec;
  t.ctiles = ctiles;
  t.state = (unsigned long long*)((char*)scratch + sizeof(CsrHdr) +
                                  sizeof(CsrAcc) * (size_t)nspec);
  csr_kernel<FinTab><<<csr_grid(tiles), CT, 0, (cudaStream_t)stream>>>(
      t, (CsrHdr*)scratch);
  ACCORD_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// A mesh shard's part of the finalize (accord_tpu_torch/parallel/mesh.py
// `sharded_finalize_csr`, replacing the JAX package's parallel/mesh.py
// `sharded_finalize_csr` :663, body `_sharded_finalize_body` :524). The
// shard holds 'data' word columns [base_w, base_w + wl) of the span: blk
// (the packed result's columns, row stride blk_stride) and kid (the kid
// table's, row stride kid_stride), read in place. One block per slot:
//   fin_shard_count   popcount of the slot's masked words -> counts[slot]
//                     (counts may be NULL: a 'model' replica that only
//                     bounds), and the kid-word popcount of the slots in
//                     [bound_lo, bound_hi) added into *bound (the 'model'
//                     slot-block split of the out-cap bound; exact ints);
//   fin_shard_compact the slot's set bits at seg_base[slot] + their rank
//                     in the slot's words, rows (base_w + w) * 32 + bit,
//                     into this shard's fragment; positions >= out_cap
//                     drop, and the fragment is zeroed first, because the
//                     fragments merge by a sum (csrc/mesh_combine.cu).
// The self-bit test uses the shard-global word index. Bound: bytes, the
// shard's S x wl words of blk and kid read twice (count, compact); a
// block walks a slot's words CT at a time, so slots wider than CT loop.
struct ShardFin {
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
__device__ __forceinline__ void shard_count_body(const ShardFin& f, int s,
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
__device__ __forceinline__ void shard_compact_body(const ShardFin& f, int s,
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

__global__ void __launch_bounds__(CT)
fin_shard_count_kernel(const ShardFin f, int s, int* __restrict__ counts,
                       int* __restrict__ bound, int bound_lo, int bound_hi) {
  shard_count_body(f, s, counts, bound, bound_lo, bound_hi);
}

__global__ void __launch_bounds__(CT)
fin_shard_compact_kernel(const ShardFin f, int s,
                         const int* __restrict__ seg_base, int out_cap,
                         int* __restrict__ frag) {
  shard_compact_body(f, s, seg_base, out_cap, frag);
}

// The sharded protocol megakernel's form (accord_tpu_torch/ops/
// tick_graph.py): one record per shard in the graph's parameter block, so
// a replay reads the tick's own packed result, kid table and lanes, and
// one launch covers every shard of a finalize (blockIdx.y the record).
struct ShardFinEnt {
  ShardFin f;
  int* counts;          // the shard's slot counts, or null ('model' > 0)
  int* bound;           // its out-cap bound partial
  const int* seg_base;  // its write bases (the compaction)
  int* frag;            // its fragment (the compaction)
  int bound_lo, bound_hi;
};

extern "C" int shard_fin_bytes() { return (int)sizeof(ShardFinEnt); }

// write the record of these operands (device pointers) to host memory dst
extern "C" int shard_fin_pack(void* dst, const void* blk, int blk_stride,
                              int b, const void* kid, int kid_stride, int kc,
                              int wl, int base_w, const void* slot_subj,
                              const void* slot_kid, const void* subj_row,
                              void* counts, void* bound, int bound_lo,
                              int bound_hi, const void* seg_base,
                              void* frag) {
  ShardFinEnt e;
  e.f = ShardFin{(const unsigned*)blk, blk_stride, b, (const unsigned*)kid,
                 kid_stride, kc, wl, base_w, (const int*)slot_subj,
                 (const int*)slot_kid, (const int*)subj_row};
  e.counts = (int*)counts;
  e.bound = (int*)bound;
  e.seg_base = (const int*)seg_base;
  e.frag = (int*)frag;
  e.bound_lo = bound_lo;
  e.bound_hi = bound_hi;
  *(ShardFinEnt*)dst = e;
  return 0;
}

__global__ void __launch_bounds__(CT)
fin_shard_count_tab_kernel(const ShardFinEnt* __restrict__ tab, int s) {
  const ShardFinEnt e = tab[blockIdx.y];
  shard_count_body(e.f, s, e.counts, e.bound, e.bound_lo, e.bound_hi);
}

__global__ void __launch_bounds__(CT)
fin_shard_compact_tab_kernel(const ShardFinEnt* __restrict__ tab, int s,
                             int out_cap) {
  const ShardFinEnt e = tab[blockIdx.y];
  shard_compact_body(e.f, s, e.seg_base, out_cap, e.frag);
}

static inline int shard_grid(int s) {
  return s < 1 ? 1 : (s > 65535 ? 65535 : s);
}

extern "C" int fin_shard_count(const void* blk, int blk_stride, int b,
                               const void* kid, int kid_stride, int kc,
                               int wl, int base_w, const void* slot_subj,
                               const void* slot_kid, int s,
                               const void* subj_row, void* counts,
                               void* bound, int bound_lo, int bound_hi,
                               void* stream) {
  if (s <= 0 || wl <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  ShardFin f{(const unsigned*)blk, blk_stride, b, (const unsigned*)kid,
             kid_stride, kc, wl, base_w, (const int*)slot_subj,
             (const int*)slot_kid, (const int*)subj_row};
  fin_shard_count_kernel<<<shard_grid(s), CT, 0, st>>>(
      f, s, (int*)counts, (int*)bound, bound_lo, bound_hi);
  ACCORD_CHECK();
  return 0;
}

extern "C" int fin_shard_compact(const void* blk, int blk_stride, int b,
                                 const void* kid, int kid_stride, int kc,
                                 int wl, int base_w, const void* slot_subj,
                                 const void* slot_kid, int s,
                                 const void* subj_row, const void* seg_base,
                                 int out_cap, void* frag, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaMemsetAsync(frag, 0, sizeof(int) * (size_t)(out_cap > 0 ? out_cap : 0),
                  st);
  ACCORD_CHECK();
  if (s <= 0 || wl <= 0 || out_cap <= 0) return 0;
  ShardFin f{(const unsigned*)blk, blk_stride, b, (const unsigned*)kid,
             kid_stride, kc, wl, base_w, (const int*)slot_subj,
             (const int*)slot_kid, (const int*)subj_row};
  fin_shard_compact_kernel<<<shard_grid(s), CT, 0, st>>>(
      f, s, (const int*)seg_base, out_cap, (int*)frag);
  ACCORD_CHECK();
  return 0;
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
  fin_shard_count_tab_kernel<<<dim3(shard_grid(s), nent), CT, 0, st>>>(
      (const ShardFinEnt*)tab, s);
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
  fin_shard_compact_tab_kernel<<<dim3(shard_grid(s), nent), CT, 0, st>>>(
      (const ShardFinEnt*)tab, s, out_cap);
  ACCORD_CHECK();
  return 0;
}
