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
// parameter block. `fin_shard_tab` (below) does the same for the sharded
// megakernel's finalizes, each read through its data shards' records.
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
  __device__ __forceinline__ FinIn src() const { return *in; }
};

// a table launch's specs (Ent: FinEnt, or ShardEnt below): tile ids in
// order -- every spec's compaction tiles, then every spec's pad tiles
// (pad0 strictly increasing)
template <class Ent>
struct EntTab {
  const Ent* ents;
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
  __device__ __forceinline__ auto src(int k) const { return ents[k].src(); }
};

// spec k's CsrOut in a table launch: s slots of w words, act_ts and its
// five outputs as finalize_csr's, `scratch` the launch's (nspec specs),
// tile0 / pad0 its first compaction and pad tile (the caller numbers
// them: every spec's csr_tiles_for(s * w) compaction tiles in order,
// then every spec's csr_pads_for(out_cap) pad tiles)
static inline CsrOut tab_out(int s, int w, const void* act_ts, int out_cap,
                             void* indptr, void* dep_rows, void* dep_ts,
                             void* bound, void* csum, void* scratch,
                             int nspec, int k, int tile0, int pad0) {
  CsrOut o = csr_out_one(s, w, (const int*)act_ts, out_cap, (int*)indptr,
                         (int*)dep_rows, (int*)dep_ts, (int*)bound,
                         (unsigned*)csum, scratch, FoldSeeds{1u, 5u, 9u});
  char* base = (char*)scratch;
  o.acc = (CsrAcc*)(base + sizeof(CsrHdr)) + k;
  o.state = (unsigned long long*)(base + sizeof(CsrHdr) +
                                  sizeof(CsrAcc) * (size_t)nspec) +
            tile0;
  o.tile0 = tile0;
  o.pad0 = pad0;
  return o;
}

// nspec specs in ONE launch over the Ent table `tab` (device memory) of
// `tiles` tiles in all, `ctiles` of them compaction tiles; scratch:
// kernels.csr_scratch_bytes(nspec, ctiles) zeroed bytes, left zeroed
template <class Ent>
static inline int launch_tab(const void* tab, int nspec, int tiles,
                             int ctiles, void* scratch, void* stream) {
  if (nspec <= 0) return 0;
  if (tiles < nspec || ctiles < 0) return (int)cudaErrorInvalidValue;
  EntTab<Ent> t;
  t.ents = (const Ent*)tab;
  t.tiles = tiles;
  t.nspec = nspec;
  t.ctiles = ctiles;
  t.state = (unsigned long long*)((char*)scratch + sizeof(CsrHdr) +
                                  sizeof(CsrAcc) * (size_t)nspec);
  csr_kernel<EntTab<Ent>><<<csr_grid(tiles), CT, 0, (cudaStream_t)stream>>>(
      t, (CsrHdr*)scratch);
  ACCORD_CHECK();
  return 0;
}

extern "C" int fin_ent_bytes() { return (int)sizeof(FinEnt); }

// write the FinEnt of one finalize to host memory `dst`: `fin` the device
// address of its FinIn (s slots of w words), the rest as tab_out's
extern "C" int fin_ent_pack(void* dst, const void* fin, int s, int w,
                            const void* act_ts, int out_cap, void* indptr,
                            void* dep_rows, void* dep_ts, void* bound,
                            void* csum, void* scratch, int nspec, int k,
                            int tile0, int pad0) {
  FinEnt e;
  e.in = (const FinIn*)fin;
  e.o = tab_out(s, w, act_ts, out_cap, indptr, dep_rows, dep_ts, bound,
                csum, scratch, nspec, k, tile0, pad0);
  *(FinEnt*)dst = e;
  return 0;
}

// nspec finalizes in ONE launch over the FinEnt table `tab`
extern "C" int finalize_csr_tab(const void* tab, int nspec, int tiles,
                                int ctiles, void* scratch, void* stream) {
  return launch_tab<FinEnt>(tab, nspec, tiles, ctiles, scratch, stream);
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
// The self-bit test uses the shard-global word index. These are the
// per-shard launches of the eager form, which shards across cards (with
// K22's counts_scan and fragment_merge); the megakernel's graph, whose
// shards share its card, runs the sharded finalize TABLE below instead.
// Bound: bytes, the shard's S x wl words of blk and kid read twice
// (count, compact); a block walks a slot's words CT at a time, so slots
// wider than CT loop.
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

// fin_shard_count: a block per slot (blockIdx.x, + gridDim.x, ...)
__global__ void __launch_bounds__(CT)
fin_shard_count_kernel(const ShardFin f, int s, int* __restrict__ counts,
                       int* __restrict__ bound, int bound_lo, int bound_hi) {
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

// fin_shard_compact: a block per slot
__global__ void __launch_bounds__(CT)
fin_shard_compact_kernel(const ShardFin f, int s,
                         const int* __restrict__ seg_base, int out_cap,
                         int* __restrict__ frag) {
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

// ---------------------------------------------------------------------------
// The sharded finalize TABLE (the sharded protocol megakernel's key
// finalizes, accord_tpu_torch/ops/tick_graph.py; the reference's
// _sharded_finalize_body inlined per finalize in its sharded tick,
// parallel/mesh.py :779): every finalize of a tick in ONE launch of K2's
// compaction (common.cuh csr_kernel), the finalize's data shards read
// through their own ShardFin records. A graph holds only shards on its own
// card, so the shards' positions are disjoint inside ONE output: the
// compaction walks each finalize's words in (slot, data shard, word)
// order -- which is (slot, span word) order, shard d holding words [d wl,
// (d + 1) wl) -- reading word wd of a slot through record wd / wl at its
// local word, and writes each set bit straight to its final dep_rows /
// dep_ts position. A compaction tile is CW consecutive words of that
// order (a run of slots x every data shard of them), so its look-back
// prefix is that of one contiguous run of positions. No counts pass, no
// scan of per-shard counts, no fragments, no sum-merge and no memset:
// pad tiles write past the total, whoever writes a value folds it, and
// the last block (by ticket) writes each finalize's checksum and bound and
// leaves the scratch zeroed. The bound is the sum over every (data,
// 'model') shard's partial -- the kid words' popcount of its slot block --
// which, being exact integers, is each in-range slot's kid popcount
// summed over its words: the tile adds each word's once, through the
// record that reads it. What bounds it: bytes, each finalize's S x w
// words of the packed result and the kid table read once (as K2's table).
//
// A thread keeps in registers the record of the shard its last word was
// read through and that shard's first word: a thread's words are
// consecutive, so the shard rarely changes between them (where each word
// divided for its shard and loaded its record's fields, the 10k tick's
// table took ~10% longer: tools/sharded_finalize_variants.py).
struct ShardSpan {
  const ShardFin* rec;   // the finalize's data shards' records
  int wl;
  mutable int c0 = -(1 << 30);   // the cached shard's first word
  mutable ShardFin cur;

  __device__ __forceinline__ unsigned word(int sl, int wd, long long,
                                           unsigned* kw) const {
    if (wd < c0 || wd >= c0 + wl) {
      const int d = wd / wl;
      cur = rec[d];
      c0 = d * wl;
    }
    return cur.word(sl, wd - c0, kw);
  }
};

// one finalize of the sharded table: its records and its CsrOut (over s
// slots of w = data * wl words)
struct ShardEnt {
  const ShardFin* rec;
  int wl;
  CsrOut o;
  __device__ __forceinline__ ShardSpan src() const {
    return ShardSpan{rec, wl};
  }
};

extern "C" int shard_fin_bytes() { return (int)sizeof(ShardFin); }

// write the ShardFin of one data shard (device pointers: blk and kid at the
// shard's first column) to host memory dst
extern "C" int shard_fin_pack(void* dst, const void* blk, int blk_stride,
                              int b, const void* kid, int kid_stride, int kc,
                              int wl, int base_w, const void* slot_subj,
                              const void* slot_kid, const void* subj_row) {
  *(ShardFin*)dst = ShardFin{(const unsigned*)blk, blk_stride, b,
                             (const unsigned*)kid, kid_stride, kc, wl,
                             base_w, (const int*)slot_subj,
                             (const int*)slot_kid, (const int*)subj_row};
  return 0;
}

extern "C" int shard_ent_bytes() { return (int)sizeof(ShardEnt); }

// write the ShardEnt of one finalize to host memory dst: `rec` the device
// address of its `data` ShardFin records (wl words each), the rest as
// fin_ent_pack's over s slots of data * wl words
extern "C" int shard_ent_pack(void* dst, const void* rec, int data, int wl,
                              int s, const void* act_ts, int out_cap,
                              void* indptr, void* dep_rows, void* dep_ts,
                              void* bound, void* csum, void* scratch,
                              int nspec, int k, int tile0, int pad0) {
  ShardEnt e;
  e.rec = (const ShardFin*)rec;
  e.wl = wl;
  e.o = tab_out(s, data * wl, act_ts, out_cap, indptr, dep_rows, dep_ts,
                bound, csum, scratch, nspec, k, tile0, pad0);
  *(ShardEnt*)dst = e;
  return 0;
}

// nspec sharded finalizes in ONE launch over the ShardEnt table `tab`
// (device memory); scratch as finalize_csr_tab's
extern "C" int fin_shard_tab(const void* tab, int nspec, int tiles,
                             int ctiles, void* scratch, void* stream) {
  return launch_tab<ShardEnt>(tab, nspec, tiles, ctiles, scratch, stream);
}
