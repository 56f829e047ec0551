// K5: the range-overlap deps query, one packed word per (subject, 32 rows)
// of each store's range arena and, for range subjects, of its key arena.
//
// Replaces accord_tpu/ops/kernels.py `range_deps_resolve` (:415) and, with
// a table of store blocks each writing its own word span,
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
// One launch a call (csrc/range_block.cuh): a CTA owns a (64-subject
// tile, row-word group) of one range block, stages its tile's intervals
// from the list in shared memory (any order), ORs each interval's overlap
// ballot into its subject's word there and applies the row masks, and
// writes each output word once (16-byte stores; a tile with no subject of
// the block writes zeros without loading a row). The covered words of the
// key side are one more row of the same grid. The key side is K1's block
// body (deps_block.cuh: ownership first, the AND over each subject's
// nonzero covered words, the tile out as 16-byte stores), one launch a key
// block.
//
// What bounds it on an H100: bytes -- the packed output, written once --
// and at a burn's size the launch; the lanes are small and sit in L2.
//
// A mesh shard (accord_tpu_torch/parallel/mesh.py, replacing the JAX
// package's parallel/mesh.py `sharded_range_deps_resolve` :256 with its
// `_covered_buckets` :239 and the per-store body `_fused_range_resolve_
// blocks` :360) runs `range_resolve` on a one-block table of its 'data'
// rows of the range arena (the pointers at the block's first row, the
// output span at its lane offset), and on the key side `range_resolve`'s
// covered pass alone over its 'model' bucket slice (base, k_local of
// k_total, the same modular test) and `range_key_block` over its rows'
// word slice of the key arena, read in place through the row stride; the 'model' partials merge by OR
// (csrc/mesh_combine.cu). Bound: K5's, on the shard's rows and bucket
// words; a shard is launch-bound at the burns' sizes.
#include <string.h>

#include "range_block.cuh"

// One launch: the range blocks of the host table `spec` (int64 words: the
// output pointer, the block count, then per block its five lane pointers
// and cap | word offset << 32; node_lane.range_table's layout) passed by
// value, and with cov set the covered words of the slices [cov_base + m *
// k_local, + k_local) of k_total buckets, m < slices, into cov + m * b *
// k_local / 32. subj_store == slots == NULL: one store, no slot mask;
// else block z answers subjects with subj_store[s] == slots[z]. More than
// RB_MAX blocks launch in chunks of RB_MAX (the covered pass in the first).
extern "C" int range_resolve(const void* spec, int nblk, const void* iv_of,
                             const void* iv_s, const void* iv_e, int nv,
                             const void* subj_before, const void* subj_kinds,
                             const void* subj_store, const void* slots,
                             int b, const void* witness, int nk,
                             int out_stride, void* cov, int cov_base,
                             int k_local, int k_total, int slices,
                             void* stream) {
  RangeArgs a;
  a.iv_of = (const int*)iv_of;
  a.iv_s = (const int*)iv_s;
  a.iv_e = (const int*)iv_e;
  a.subj_before = (const int*)subj_before;
  a.subj_kinds = (const int*)subj_kinds;
  a.subj_store = (const int*)subj_store;
  a.slots = (const int*)slots;
  a.witness = (const int*)witness;
  a.cov = (unsigned*)cov;
  a.nv = nv;
  a.b = b;
  a.nk = nk;
  a.out_stride = out_stride;
  a.cov_base = cov_base;
  a.k_local = k_local;
  a.k_total = k_total;
  a.slices = slices;
  if (!range_args_ok(a) || nblk < 0) return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  long long w[2];
  memcpy(w, spec, sizeof(w));
  int z0 = 0;
  do {
    RngTabV t;
    const int n = nblk - z0 < RB_MAX ? nblk - z0 : RB_MAX;
    t.h.out = (unsigned*)w[0];
    t.h.nblk = n;
    int max_cap = 0;
    for (int z = 0; z < n; ++z) {
      long long f[6];
      memcpy(f, (const char*)spec + sizeof(w) + sizeof(f) * (z0 + z),
             sizeof(f));
      RngBlk& bk = t.blk[z];
      bk.start = (const int*)f[0];
      bk.end = (const int*)f[1];
      bk.ts = (const int*)f[2];
      bk.kinds = (const int*)f[3];
      bk.valid = (const unsigned char*)f[4];
      bk.cap = (int)(f[5] & 0xffffffffLL);
      bk.out_off = (int)(f[5] >> 32);
      if (bk.cap < 0 || (bk.cap & 31)) return (int)cudaErrorInvalidValue;
      if (bk.cap > max_cap) max_cap = bk.cap;
    }
    RangeArgs c = a;
    c.nblk = n;
    c.slots = a.slots == nullptr ? nullptr : a.slots + z0;
    if (z0 > 0) c.cov = nullptr;
    if (n > 0 || c.cov != nullptr) {
      const dim3 grid = range_geom(c, max_cap);
      range_val_kernel<<<grid, RB_THREADS, 0, st>>>(t, c);
      ACCORD_CHECK();
    }
    z0 += n;
  } while (z0 < nblk);
  return 0;
}

// One key block of a range query: K1's block kernel over the covered words,
// gated by subj_is_range (and, fused, by the block's store slot); row r's
// nw bucket words are act_bm[r * bm_stride ...].
extern "C" int range_key_block(const void* cov, const void* subj_before,
                               const void* subj_kinds,
                               const void* subj_is_range,
                               const void* subj_store, const void* slot,
                               int b, const void* act_bm, int bm_stride,
                               const void* act_ts, const void* act_kinds,
                               const void* act_valid, int cap, int nw,
                               const void* witness, int nk, void* out,
                               int stride, int off, void* stream) {
  return launch_resolve(cov, subj_before, subj_kinds, subj_store, slot,
                        subj_is_range, b, act_bm, bm_stride, act_ts,
                        act_kinds, act_valid, cap, nw, witness, nk, out,
                        stride, off, (cudaStream_t)stream);
}
