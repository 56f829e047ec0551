// K5's range side and its covered-bucket pass, shared with K14
// (node_resolve.cu) and the mesh's range shards: ONE launch a call over a
// table of range blocks, the covered words of the key side in the same
// launch.
//
// A range block is one range arena (or a mesh shard's 'data' rows of one):
// its start / end / ts / kind / valid lanes, its cap (a multiple of 32) and
// the word column of the output where its packed words go. Row r of block z
// is a candidate of subject s when some interval of s overlaps it
// (iv_start < r_end & r_start < iv_end), AND witness, AND the row's ts is
// before the subject's bound, AND valid, AND (fused, node, shard) the
// subject's store or node slot is the block's. The interval list
// (iv_of, iv_start, iv_end) comes in any order: iv_of == B is padding and
// is dropped, a negative iv_of counts from the end once (norm_index).
//
// The grid is (run of 64-subject tiles, block, row-word group), as the key
// body's (deps_block.cuh); a CTA owns a tile x group of its block's output
// and writes each output word once:
//   1. ownership first: the CTA reads its tiles' slots alone; a tile with no
//      subject of the block writes its zero tile as 16-byte stores and
//      moves on, loading no interval and no row; so does a tile whose row
//      words hold no valid row (their valid bytes are read next);
//   2. the tile's intervals: the CTA filters the whole list (16-byte loads,
//      a ballot a warp, a popc prefix, no barrier inside the pass) and
//      stages the entries of its owned subjects in shared memory, then
//      gathers their endpoints with every load in flight at once; whatever
//      the list's order, each interval of the tile is staged once. A tile
//      with more than RB_IV_CAP intervals is staged and consumed in rounds;
//   3. overlap: a warp holds up to RB_WPW of the group's valid row words
//      (lane i: row 32 w + i's start and end in registers); each lane
//      takes two staged intervals and walks every row of the warp's
//      words, each row broadcast by __shfl_sync from its lane: one
//      compare pair an interval and row, and the word OR-ed into its
//      subject's word of a shared [64 x 33] tile (a shared atomic: lanes
//      may share a subject) -- no scratch in global memory, no global
//      atomics. (Rows broadcast from shared memory instead gave words
//      that differed from run to run on the card; see PERF.md.)
//   4. masks: lane i holds subjects i and i + 32 (bound, witness row as
//      bits over row kinds, loaded before the walk with the first word's
//      ts and kinds); the warp walks the rows of each of its words that
//      are valid and overlap some subject (an OR-reduce of the warp),
//      each row's ts and kind broadcast from its lane;
//   5. the tile leaves as 16-byte stores (key_store_tile).
// The covered-bucket pass -- bucket j of the slice [base, base + k_local)
// of k_total buckets is covered by [s, e) iff (j - s) mod k_total < e - s in
// wrapping int32, widths <= 0 or >= k_total cover everything (k_total a
// power of two, so the unsigned mask IS the floor mod) -- is one more row
// of the grid (blockIdx.y == nblk, blockIdx.z the 'model' slice): a CTA
// stages its tile's intervals the same way (no slot mask); a thread an
// interval ORs its run of buckets, [s mod K, + width) cut to the slice,
// word by word into shared memory (a shared atomicOr: a subject's
// intervals may share a word), and the tile's words leave once. Slice m's
// words go to cov + m * b * (k_local / 32), its buckets from base + m *
// k_local.
//
// What bounds it on an H100: bytes -- the output, B x sum(cap)/32 words,
// written once, mostly zero words at a merged tick's size -- and, at a
// burn's size, the launch; the interval compares (2 an interval and row of
// an owned tile) sit in registers and shared memory.
#pragma once

#include "deps_block.cuh"

#define RB_THREADS 128
#define RB_VEC 4           // 16-byte loads of iv_of in flight a thread
#define RB_CHUNK (RB_THREADS * RB_VEC * 4)  // list entries a CTA filters a pass
#define RB_IV_CAP 1024     // intervals a tile stages (consumed in rounds)
#define RB_MAX 32          // range blocks of a by-value table (one launch)
#define RB_WPW (KT_WORDS / (RB_THREADS / 32))  // row words a warp holds

struct RngBlk {              // 48 bytes
  const int* start;          // [cap]
  const int* end;
  const int* ts;             // [cap, 3]
  const int* kinds;
  const unsigned char* valid;
  int cap, out_off;
};

struct TabHdr {              // 16 bytes, then the blocks
  unsigned* out;
  long long nblk;
};

// a table passed by value (the single-store, fused and shard wrappers)
struct RngTabV {
  TabHdr h;
  RngBlk blk[RB_MAX];
};

// one launch's lanes, statics and geometry
struct RangeArgs {
  const int* iv_of;
  const int* iv_s;
  const int* iv_e;
  const int* subj_before;
  const int* subj_kinds;
  const int* subj_store;     // null: no slot mask (single store)
  const int* slots;          // block z's slot is slots[z]
  const int* witness;
  unsigned* cov;             // null: no covered pass
  int nv, b, nk, out_stride;
  int nblk, gw, ty;
  int cov_base, k_local, k_total, slices;
};

struct RangeSmem {
  int ivs[RB_IV_CAP];
  int ive[RB_IV_CAP];
  int ivo[RB_IV_CAP];              // the interval's subject in the tile
  unsigned acc[KT_SUBJ * KT_OUT];  // [subject][word], KT_OUT odd
  int pos[KT_SUBJ];                // its row of acc, or -1: zero words
  int mine[KT_SUBJ];
  unsigned vm[KT_WORDS];           // valid rows of each row word
  int wit[64];
  int niv;
};

// Stage the tile's intervals (subjects s0 .. s0 + ns with mine[] set) and
// hand them to consume(n); pos[s] = s for a subject with an interval. One
// pass over the list, no barrier inside it: each warp appends its
// matches (a ballot, a popc prefix, one shared atomic a warp). A tile
// with more than RB_IV_CAP intervals is staged again in rounds of at most
// RB_IV_CAP (each round a chunk of the list, consumed before the next).
// Every thread reaches every barrier.
template <typename F>
__device__ __forceinline__ void range_stage(const RangeArgs& a, RangeSmem& S,
                                            int s0, int ns, F consume) {
  const int tid = threadIdx.x, lane = tid & 31;
  // 16-byte loads where the list is aligned (c0 is a multiple of 4)
  const bool vec = ((uintptr_t)a.iv_of & 15) == 0;
  auto scan = [&](int c0, int c1, bool mark) {
    for (int c = c0; c < c1; c += RB_CHUNK) {
      int o[RB_VEC * 4];
#pragma unroll
      for (int k = 0; k < RB_VEC; ++k) {
        const int e = c + ((k * RB_THREADS + tid) << 2);
        int4 v;
        if (vec && e + 3 < c1) {
          v = *reinterpret_cast<const int4*>(a.iv_of + e);
        } else {
          v.x = e < c1 ? a.iv_of[e] : a.b;
          v.y = e + 1 < c1 ? a.iv_of[e + 1] : a.b;
          v.z = e + 2 < c1 ? a.iv_of[e + 2] : a.b;
          v.w = e + 3 < c1 ? a.iv_of[e + 3] : a.b;
        }
        o[4 * k] = norm_index(v.x, a.b) - s0;
        o[4 * k + 1] = norm_index(v.y, a.b) - s0;
        o[4 * k + 2] = norm_index(v.z, a.b) - s0;
        o[4 * k + 3] = norm_index(v.w, a.b) - s0;
      }
#pragma unroll
      for (int q = 0; q < RB_VEC * 4; ++q) {
        const int e = c + (((q >> 2) * RB_THREADS + tid) << 2) + (q & 3);
        const int ok = o[q];
        const bool hit = ok >= 0 && ok < ns && S.mine[ok];
        const unsigned m = __ballot_sync(0xffffffffu, hit);
        if (!m) continue;                            // warp-uniform
        int base = 0;
        if (lane == 0) base = atomicAdd(&S.niv, __popc(m));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (hit) {
          const int p = base + __popc(m & ((1u << lane) - 1u));
          if (mark) S.pos[ok] = ok;
          if (p < RB_IV_CAP) {
            S.ivs[p] = e;                  // its interval, gathered below
            S.ivo[p] = ok;
          }
        }
      }
    }
  };
  // the staged entries' endpoints, every load in flight at once
  auto gather = [&](int n) {
    for (int i = tid; i < n; i += RB_THREADS) {
      const int e = S.ivs[i];
      S.ivs[i] = a.iv_s[e];
      S.ive[i] = a.iv_e[e];
    }
  };
  scan(0, a.nv, true);
  __syncthreads();
  const int n = S.niv;
  if (n <= RB_IV_CAP) {
    gather(n);
    __syncthreads();
    if (n > 0) consume(n);
    __syncthreads();
    return;
  }
  __syncthreads();                      // every thread has read niv
  // more than RB_IV_CAP: chunks of the list of at most RB_IV_CAP entries
  for (int c = 0; c < a.nv; c += RB_IV_CAP) {
    if (tid == 0) S.niv = 0;
    __syncthreads();
    scan(c, min(c + RB_IV_CAP, a.nv), false);
    __syncthreads();
    const int m = S.niv;
    gather(m);
    __syncthreads();
    if (m > 0) consume(m);
    __syncthreads();
  }
}

// the position of the n-th (from 0) set bit of m, or -1
__device__ __forceinline__ int nth_bit(unsigned m, int n) {
  for (int i = 0; i < n; ++i) m &= m - 1u;
  return m ? __ffs(m) - 1 : -1;
}

// The valid rows of the group's row words into S.vm (lane i of a ballot:
// row 32 w + i); returns whether any row of the group is valid.
__device__ __forceinline__ bool range_valid_words(
    RangeSmem& S, const unsigned char* __restrict__ valid, int w0, int tw) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned vr[KT_WORDS * 32 / RB_THREADS];
#pragma unroll
  for (int i = 0; i < KT_WORDS * 32 / RB_THREADS; ++i) {
    const int r = i * RB_THREADS + tid;
    vr[i] = r < tw * 32 ? valid[(w0 << 5) + r] : 0u;
  }
  int any = 0;
#pragma unroll
  for (int i = 0; i < KT_WORDS * 32 / RB_THREADS; ++i) {
    const unsigned m = __ballot_sync(0xffffffffu, vr[i] != 0u);
    if (lane == 0) S.vm[i * (RB_THREADS / 32) + warp] = m;
    any |= m != 0u;
  }
  return __syncthreads_or(any);
}

// One range block's tile run: blockIdx.x the run of subject tiles,
// blockIdx.z * gw its first row word.
__device__ __forceinline__ void range_tiles(const RangeArgs& a, RangeSmem& S,
                                            const RngBlk& bk, int slot,
                                            unsigned* __restrict__ out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.z * a.gw;
  const int tw = min(a.gw, (bk.cap >> 5) - w0);
  unsigned* const dst = out + bk.out_off + w0;
  const int t_first = blockIdx.x * a.ty;
  unsigned own = 0u;
  if (tid < KT_SUBJ) {
    for (int ty = 0; ty < a.ty; ++ty) {
      const int s = (t_first + ty) * KT_SUBJ + tid;
      if (s < a.b && (a.subj_store == nullptr || a.subj_store[s] == slot))
        own |= 1u << ty;
    }
  }
  bool vm_loaded = false, any_valid = false;
  for (int ty = 0; ty < a.ty; ++ty) {
    const int s0 = (t_first + ty) * KT_SUBJ;
    if (s0 >= a.b) break;                               // uniform
    const int ns = min(KT_SUBJ, a.b - s0);
    const int mine = (own >> ty) & 1;
    if (tid < KT_SUBJ) {
      S.mine[tid] = mine;
      S.pos[tid] = -1;
    }
    if (tid == 0) S.niv = 0;
    if (!__syncthreads_or(mine)) {
      key_store_tile(dst, a.out_stride, s0, ns, tw, nullptr, nullptr);
      continue;
    }
    if (!vm_loaded) {               // the group's valid rows, once a CTA
      any_valid = range_valid_words(S, bk.valid, w0, tw);
      vm_loaded = true;
    }
    if (!any_valid) {
      key_store_tile(dst, a.out_stride, s0, ns, tw, nullptr, nullptr);
      continue;
    }
    for (int i = tid; i < KT_SUBJ * KT_OUT; i += RB_THREADS) S.acc[i] = 0u;
    // the valid row words, dealt round the warps: word j of this warp is
    // the (warp + 4 j)-th valid one; lane j keeps word j's index
    const unsigned vwm =
        __ballot_sync(0xffffffffu, lane < tw && S.vm[lane] != 0u);
    constexpr int NWARP = RB_THREADS / 32;
    const int nvw = __popc(vwm);
    const int nj = nvw > warp ? (nvw - warp + NWARP - 1) / NWARP : 0;
    const int my_wl = lane < nj ? nth_bit(vwm, warp + lane * NWARP) : 0;
    // the warp's words' rows in registers (lane i: row 32 w + i's start
    // and end), every load in flight at once
    int rs[RB_WPW], re[RB_WPW];
#pragma unroll
    for (int j = 0; j < RB_WPW; ++j) {
      const int w = __shfl_sync(0xffffffffu, my_wl, j);
      const int row = ((w0 + w) << 5) + lane;
      rs[j] = j < nj ? bk.start[row] : 0;
      re[j] = j < nj ? bk.end[row] : 0;
    }
    // issued here too, so no load waits after the walk: the first word's
    // rows' ts and kind, and the owned subjects' bounds and witness rows
    // (lane i: subjects i and i + 32)
    int f0 = 0, f1 = 0, f2 = 0, fk = 0;
    if (nj > 0) {
      const int row = ((w0 + __shfl_sync(0xffffffffu, my_wl, 0)) << 5) + lane;
      f0 = bk.ts[row * 3];
      f1 = bk.ts[row * 3 + 1];
      f2 = bk.ts[row * 3 + 2];
      fk = bk.kinds[row];
    }
    int4 q[2];
    unsigned qw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int sl = lane + 32 * h;
      q[h] = make_int4(0, 0, 0, 0);
      qw[h] = 0u;
      if (sl < ns && S.mine[sl]) {
        int kd = a.subj_kinds[s0 + sl];
        if (kd < 0) kd += a.nk;             // a jnp gather: wrap, then clamp
        kd = min(max(kd, 0), a.nk - 1);
        const int* bf = a.subj_before + (long long)(s0 + sl) * 3;
        q[h] = make_int4(bf[0], bf[1], bf[2], kd);
        for (int k = 0; k < a.nk; ++k)
          qw[h] |= (unsigned)(S.wit[kd * a.nk + k] == 1) << k;
      }
    }
    range_stage(a, S, s0, ns, [&](int n) {
      // two intervals a lane (64 a pass); each row of a word broadcast
      // from its lane's registers: one compare pair an interval and row,
      // the word OR-ed into the subject's (a shared atomic: lanes may
      // share a subject)
      for (int i0 = 0; i0 < n; i0 += 64) {
        int sa = 0x7fffffff, ea = (int)0x80000000, oa = 0;
        int sb = 0x7fffffff, eb = (int)0x80000000, ob = 0;
        if (i0 + lane < n) {
          sa = S.ivs[i0 + lane];
          ea = S.ive[i0 + lane];
          oa = S.ivo[i0 + lane];
        }
        if (i0 + 32 + lane < n) {
          sb = S.ivs[i0 + 32 + lane];
          eb = S.ive[i0 + 32 + lane];
          ob = S.ivo[i0 + 32 + lane];
        }
#pragma unroll
        for (int j = 0; j < RB_WPW; ++j) {
          if (j < nj) {                                   // warp-uniform
            unsigned ba = 0u, bb = 0u;
#pragma unroll 8
            for (int r = 0; r < 32; ++r) {
              const int x = __shfl_sync(0xffffffffu, rs[j], r);
              const int y = __shfl_sync(0xffffffffu, re[j], r);
              ba |= (unsigned)(sa < y && x < ea) << r;
              bb |= (unsigned)(sb < y && x < eb) << r;
            }
            const int w = __shfl_sync(0xffffffffu, my_wl, j);
            if (ba) atomicOr(&S.acc[oa * KT_OUT + w], ba);
            if (bb) atomicOr(&S.acc[ob * KT_OUT + w], bb);
          }
        }
      }
    });
    // the masks: lane i holds subjects i and i + 32 (bound, witness row as
    // bits over row kinds, loaded above, and this word's overlap bits); a
    // warp walks the rows of its words that are valid and overlap some
    // subject, each row's ts and kind broadcast from its lane, and each
    // lane packs its subjects' words bit by bit
#pragma unroll 1
    for (int j = 0; j < nj; ++j) {
      const int w = __shfl_sync(0xffffffffu, my_wl, j);
      unsigned* at0 = &S.acc[lane * KT_OUT + w];
      unsigned* at1 = &S.acc[(lane + 32) * KT_OUT + w];
      const unsigned a0 = *at0, a1 = *at1;
      const unsigned want = S.vm[w] & __reduce_or_sync(0xffffffffu, a0 | a1);
      if (!want) {                                        // warp-uniform
        *at0 = 0u;
        *at1 = 0u;
        continue;
      }
      const int row = ((w0 + w) << 5) + lane;
      const int t0 = j == 0 ? f0 : bk.ts[row * 3];
      const int t1 = j == 0 ? f1 : bk.ts[row * 3 + 1];
      const int t2 = j == 0 ? f2 : bk.ts[row * 3 + 2];
      int rk = j == 0 ? fk : bk.kinds[row];
      if (rk < 0) rk += a.nk;
      rk = min(max(rk, 0), a.nk - 1);
      unsigned r0 = 0u, r1 = 0u;
      for (unsigned m = want; m; m &= m - 1u) {
        const int r = __ffs(m) - 1;                       // uniform
        const int b0 = __shfl_sync(0xffffffffu, t0, r);
        const int b1 = __shfl_sync(0xffffffffu, t1, r);
        const int b2 = __shfl_sync(0xffffffffu, t2, r);
        const int kr = __shfl_sync(0xffffffffu, rk, r);
        if (((a0 >> r) & 1u) && ((qw[0] >> kr) & 1u) &&
            lex_before(b0, b1, b2, q[0].x, q[0].y, q[0].z))
          r0 |= 1u << r;
        if (((a1 >> r) & 1u) && ((qw[1] >> kr) & 1u) &&
            lex_before(b0, b1, b2, q[1].x, q[1].y, q[1].z))
          r1 |= 1u << r;
      }
      *at0 = r0;
      *at1 = r1;
    }
    __syncthreads();
    key_store_tile(dst, a.out_stride, s0, ns, tw, S.acc, S.pos);
    __syncthreads();             // the next tile rewrites pos and acc
  }
}

// The covered words of a tile run: blockIdx.z the 'model' slice.
__device__ __forceinline__ void covered_tiles(const RangeArgs& a,
                                              RangeSmem& S) {
  const int tid = threadIdx.x;
  const int m = blockIdx.z;
  const int nwl = a.k_local >> 5;
  const unsigned base = (unsigned)(a.cov_base + m * a.k_local);
  const unsigned kmask = (unsigned)(a.k_total - 1);
  unsigned* const dst = a.cov + (long long)m * a.b * nwl;
  const int t_first = blockIdx.x * a.ty;
  for (int ty = 0; ty < a.ty; ++ty) {
    const int s0 = (t_first + ty) * KT_SUBJ;
    if (s0 >= a.b) break;                               // uniform
    const int ns = min(KT_SUBJ, a.b - s0);
    if (tid < KT_SUBJ) {
      S.mine[tid] = 1;
      S.pos[tid] = -1;
    }
    if (tid == 0) S.niv = 0;
    for (int i = tid; i < KT_SUBJ * KT_OUT; i += RB_THREADS) S.acc[i] = 0u;
    __syncthreads();
    range_stage(a, S, s0, ns, [&](int n) {
      // a thread an interval: its buckets [s mod K, + width) mod K, cut to
      // the slice, OR-ed word by word (a wide one: every word)
      for (int i = tid; i < n; i += RB_THREADS) {
        const unsigned s = (unsigned)S.ivs[i];
        const int width = (int)((unsigned)S.ive[i] - s);  // wrapping int32
        unsigned* row = &S.acc[S.ivo[i] * KT_OUT];
        if (width <= 0 || width >= a.k_total) {
          for (int wd = 0; wd < nwl; ++wd) atomicOr(&row[wd], 0xffffffffu);
          continue;
        }
        const unsigned lo0 = s & kmask, hi0 = lo0 + (unsigned)width;
        // the run [lo0, hi0), and its wrapped part [0, hi0 - K)
        for (int seg = 0; seg < 2; ++seg) {
          unsigned lo = seg ? 0u : lo0;
          unsigned hi = seg ? (hi0 > kmask + 1u ? hi0 - (kmask + 1u) : 0u)
                            : min(hi0, kmask + 1u);
          lo = max(lo, base);
          hi = min(hi, base + (unsigned)a.k_local);
          for (unsigned x = lo; x < hi;) {
            const unsigned wd = (x - base) >> 5;
            const unsigned y = min(hi, base + ((wd + 1u) << 5));
            const unsigned b0 = (x - base) & 31u, b1 = y - base - (wd << 5);
            const unsigned mask = (b1 == 32u ? 0xffffffffu : (1u << b1) - 1u)
                                  & ~((1u << b0) - 1u);
            atomicOr(&row[wd], mask);
            x = y;
          }
        }
      }
    });
    // every subject's words leave (zero where it has no interval)
    if (tid < KT_SUBJ) S.pos[tid] = tid;
    __syncthreads();
    key_store_tile(dst, nwl, s0, ns, nwl, S.acc, S.pos);
    __syncthreads();
  }
}

__device__ __forceinline__ void range_body(const RangeArgs& a,
                                           const TabHdr* h,
                                           const RngBlk* blks) {
  __shared__ RangeSmem S;
  const int z = blockIdx.y;
  if (z == a.nblk) {                                    // the covered row
    if ((int)blockIdx.z >= a.slices) return;            // whole CTA
    covered_tiles(a, S);
    return;
  }
  const RngBlk& bk = blks[z];
  if ((int)blockIdx.z * a.gw >= (bk.cap >> 5)) return;  // whole CTA
  if (threadIdx.x < a.nk * a.nk) S.wit[threadIdx.x] = a.witness[threadIdx.x];
  range_tiles(a, S, bk, a.subj_store == nullptr ? 0 : a.slots[z], h->out);
}

__global__ void __launch_bounds__(RB_THREADS)
range_tab_kernel(const unsigned char* __restrict__ tab,
                 const __grid_constant__ RangeArgs a) {
  range_body(a, (const TabHdr*)tab,
             (const RngBlk*)(tab == nullptr ? nullptr : tab + sizeof(TabHdr)));
}

__global__ void __launch_bounds__(RB_THREADS)
range_val_kernel(const __grid_constant__ RngTabV t,
                 const __grid_constant__ RangeArgs a) {
  range_body(a, &t.h, t.blk);
}

// The grid of a range launch over nblk blocks of at most max_cap rows (plus
// the covered row when a.cov is set): a.gw and a.ty as key_geom chooses
// them (gw narrowed, down to 4 words, while the grid is under two CTAs an
// SM; a CTA walks ty subject tiles while the grid stays over KT_CTAS).
static inline dim3 range_geom(RangeArgs& a, int max_cap) {
  const long long tiles = (a.b + KT_SUBJ - 1) / KT_SUBJ;
  const long long words = max_cap >> 5;
  const long long rows = a.nblk + (a.cov != nullptr ? 1 : 0);
  int gw = KT_WORDS;
  while (gw > 4 && ((words + gw - 1) / gw) * tiles * rows < 2 * sm_count())
    gw >>= 1;
  long long gx = (words + gw - 1) / gw;
  long long ty = 1;
  while (ty < KT_TY && gx * ((tiles + 2 * ty - 1) / (2 * ty)) * rows >=
                           KT_CTAS)
    ty *= 2;
  a.gw = gw;
  a.ty = (int)ty;
  if (a.cov != nullptr && a.slices > gx) gx = a.slices;
  if (gx < 1) gx = 1;
  return dim3((unsigned)((tiles + ty - 1) / ty), (unsigned)rows,
              (unsigned)gx);
}

// The arguments every entry checks: nk, the covered slice geometry
static inline bool range_args_ok(const RangeArgs& a) {
  if (a.nk * a.nk > 64 || a.nk < 1 || a.b < 0 || a.nv < 0)
    return false;
  if (a.cov == nullptr) return true;
  const int kt = a.k_total;
  return kt >= 32 && (kt & (kt - 1)) == 0 && a.k_local > 0 &&
         (a.k_local & 31) == 0 && a.k_local <= KT_WORDS * 32 &&
         a.slices >= 1 && a.cov_base >= 0 &&
         (long long)a.cov_base + (long long)a.slices * a.k_local <= kt;
}

// One launch over a block table in device memory (TabHdr, then nblk
// RngBlk; null when nblk == 0) and, with a.cov, the covered pass.
static inline int launch_range_tab(const void* tab, int max_cap, RangeArgs a,
                                   cudaStream_t st) {
  if (!range_args_ok(a) || (max_cap & 31) || a.nblk < 0 ||
      a.nblk > 65534)
    return (int)cudaErrorInvalidValue;
  if (a.b <= 0 || (a.nblk == 0 && a.cov == nullptr)) return 0;
  if (a.nblk > 0 && max_cap <= 0 && a.cov == nullptr) return 0;
  const dim3 grid = range_geom(a, max_cap);
  range_tab_kernel<<<grid, RB_THREADS, 0, st>>>(
      (const unsigned char*)tab, a);
  ACCORD_CHECK();
  return 0;
}
