// K1's block kernel, shared with K5's key side (range_resolve.cu) and
// K13/K14 (node_resolve.cu, through resolve_body): one packed dependency
// word per (subject, 32 arena rows) of one store block.
//
// A CTA owns output tiles of KT_SUBJ subjects x KT_WORDS row words (128
// bytes of each subject's output row; fewer where the block's cap ends
// first, or where a call is so small that its grid would hold fewer than
// two CTAs an SM: then the tile narrows, to 4 words at least, so a burn's
// small call spreads over the card as the parent's did). Most tiles of a merged tick own no subject of their block, and
// the output is mostly zero words, so the body is built to skip:
//   1. ownership before any load: the CTA reads only its tiles' store (or
//      node) slots and gate bytes first (all its tiles' at once, one bit a
//      tile in a register); a tile with no subject of this block writes
//      its zero tile and the CTA moves on, never touching the subject
//      words, the witness table or the arena lanes. Where the grid would
//      exceed KT_CTAS CTAs (a node table's many blocks), a CTA walks up to
//      KT_TY subject tiles, so zero tiles cost their stores, not a CTA each;
//   2. coalesced output: a tile leaves as 16-byte vector stores,
//      neighbouring threads on neighbouring addresses, with scalar stores
//      at the ragged ends (a cap under the tile width, an out_off or
//      out_stride that is no multiple of 4 words); on the hit path the
//      packed words are staged in shared memory and leave the same way;
//   3. sparse words: an owned subject's first KT_REG nonzero words are
//      compacted in shared memory, with its nonzero-word mask (one warp a
//      subject: one ballot, a popc prefix), and a warp's 32 arena rows'
//      words go there too (row stride nw | 1, odd, so `rows[r * stride +
//      j]` over lanes' j is free of bank conflicts). The AND runs over the
//      subject's nonzero words only: the first KT_REG (a 1-4 key PreAccept
//      subject's all) in registers, where the parent walked all 32 for
//      every pair that passed the masks; a subject with more (K5's and
//      K14's covered words, up to nw) ANDs the rest only where the row's
//      word is nonzero too (each row's nonzero-word mask from a ballot as
//      its words load, taken where the tile holds such a subject): where
//      the subject's word is all ones (an interval's inner words) that is
//      a hit, else the word is read from the subject's own row;
//   4. the cheap masks first: a row word with no valid row writes zeros
//      without loading its rows, and within a word only valid rows are
//      walked. A lane holds one or two owned subjects (their bounds, the
//      witness row as a bit mask over row kinds, their words); a warp
//      walks its row word's valid rows uniformly (each row's ts and kind
//      broadcast by `__shfl_sync`), tests witness and lexicographic before
//      and the AND in each subject's lane, and the lane packs its
//      subject's word bit by bit, so no ballot a (subject, row word) is
//      needed (`__ballot_sync` finds the valid rows and the nonzero words).
// One launch per call, no memset, no scratch: key_geom gives the grid, the
// block and the dynamic shared bytes (< 48 KB at nw = 32) in one place.
#pragma once

#include "common.cuh"

#define MAX_NW 32      // K <= 1024 buckets: a row's words fit one warp
#define SUBJ_TILE 64   // K5's range-side mask tile (range_block.cuh)
#define WARPS 4        // its 32-row words per block

#define KT_SUBJ 64     // subjects of one key-body tile
#define KT_WORDS 32    // row words of one key-body tile (128 B a subject)
#define KT_WARPS 4     // a warp a row word at a time: 8 row words each
#define KT_THREADS (KT_WARPS * 32)
#define KT_MIN_CTAS 5  // CTAs an SM must hold: caps registers at 102 a thread
                       // (the dense walk's instance would take 168)
#define KT_OUT (KT_WORDS + 1)  // staged output row stride (odd: no conflicts)
#define KT_REG 4       // a subject's nonzero words held in registers
#define KT_TY 8        // most subject tiles one CTA walks
#define KT_CTAS 2048   // the grid a CTA walks more tiles to stay above

// the odd shared-memory row stride of a warp's arena rows
__host__ __device__ __forceinline__ int key_row_stride(int nw) {
  return nw | 1;
}

// dynamic shared bytes of one key-body CTA: subject info (int4: before,
// kind), staged output words, the first KT_REG nonzero words of each
// owned subject ([KT_REG][KT_SUBJ]; their indices are the low set bits of
// its mask), and each warp's 32 arena rows (27.4 KB at nw = 32, under the
// 48 KB that needs no opt-in)
__host__ __device__ __forceinline__ int key_smem_bytes(int nw) {
  return KT_SUBJ * 16 + KT_SUBJ * KT_OUT * 4 + KT_SUBJ * KT_REG * 4 +
         KT_WARPS * 32 * key_row_stride(nw) * 4;
}

struct KeyGeom {
  dim3 grid;
  int threads;
  int smem;
  int gw;        // row words a tile (KT_WORDS, or fewer for a small call)
};

// the launch of a key body over `nz` blocks of at most `cap` rows: grid
// (run of subject tiles, block, row-word group). The card dispatches x
// fastest, so the first row words of every block and subject tile start
// first: an arena keeps its live rows in front, so the CTAs with rows to
// walk start in the first wave and those of empty words fill in after. A
// CTA walks ty subject tiles, ty the largest power of 2 <= KT_TY that
// keeps the grid at KT_CTAS CTAs or more (1 for a K1 batch). A grid under
// two CTAs an SM narrows its tiles instead.
static inline KeyGeom key_geom(int cap, int b, int nw, int nz) {
  KeyGeom g;
  const long long tiles = (b + KT_SUBJ - 1) / KT_SUBJ;
  const long long words = cap >> 5;
  int gw = KT_WORDS;
  while (gw > 4 && ((words + gw - 1) / gw) * tiles * nz < 2 * sm_count())
    gw >>= 1;
  const long long gx = (words + gw - 1) / gw;
  long long ty = 1;
  while (ty < KT_TY && gx * ((tiles + 2 * ty - 1) / (2 * ty)) * nz >=
                           KT_CTAS)
    ty *= 2;
  g.grid = dim3((unsigned)((tiles + ty - 1) / ty), nz, (unsigned)gx);
  g.threads = KT_THREADS;
  g.smem = key_smem_bytes(nw);
  g.gw = gw;
  return g;
}

// the CTA's tile out: rows s in [0, ns) of dst + (s0 + s) * stride, words
// [0, tw); subject s's words are s_out[s_pos[s] * KT_OUT ...], or zero
// where s_pos[s] < 0 or s_out is null. Thread i takes one 16-byte chunk
// of one row (chunks aligned in memory): whole chunks go as one uint4
// store, a row's ragged ends word by word.
__device__ __forceinline__ void key_store_tile(
    unsigned* __restrict__ dst, int stride, int s0, int ns, int tw,
    const unsigned* s_out, const int* s_pos) {
  const int chunks = (tw + 6) >> 2;
  for (int i = threadIdx.x; i < ns * chunks; i += blockDim.x) {
    const int s = i / chunks, c = i - s * chunks;
    unsigned* row = dst + (long long)(s0 + s) * stride;
    const int head = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
    const int lo = (c << 2) - head;
    if (lo >= tw) continue;
    const int a = s_out == nullptr ? -1 : s_pos[s];
    const unsigned* src = s_out + (a < 0 ? 0 : a * KT_OUT);
    if (lo >= 0 && lo + 4 <= tw) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (a >= 0) v = make_uint4(src[lo], src[lo + 1], src[lo + 2],
                                 src[lo + 3]);
      *reinterpret_cast<uint4*>(row + lo) = v;
    } else {
      for (int k = max(lo, 0); k < min(lo + 4, tw); ++k)
        row[k] = a < 0 ? 0u : src[k];
    }
  }
}

// The owned subjects of one lane (a and a + 32 of the tile's list): bounds,
// witness row as bits over row kinds, its first KT_REG nonzero words (index
// and word), the masks of the rest and of its all-ones words, and its row
// of subject words
struct KeySubj {
  int b0, b1, b2;
  unsigned wit, rest, full;
  const unsigned* sw;
  int j[KT_REG];
  unsigned w[KT_REG];
};

__device__ __forceinline__ void key_subj_load(
    KeySubj& q, int a, int nact, const int4* s_info, const int* s_sub,
    const unsigned* s_nzm, const unsigned* s_fm, const unsigned* s_lw,
    const int* s_wit, int nk, const unsigned* subj_words, int s0, int nw) {
  q.wit = 0u;
  q.full = 0u;
  q.b0 = q.b1 = q.b2 = 0;
  q.sw = subj_words;
  unsigned nz = 0u;
  if (a < nact) {
    q.sw = subj_words + (long long)(s0 + s_sub[a]) * nw;
    const int4 inf = s_info[s_sub[a]];
    q.b0 = inf.x;
    q.b1 = inf.y;
    q.b2 = inf.z;
    for (int k = 0; k < nk; ++k)
      q.wit |= (unsigned)(s_wit[inf.w * nk + k] == 1) << k;
    nz = s_nzm[a];
    q.full = s_fm[a];
  }
#pragma unroll
  for (int e = 0; e < KT_REG; ++e) {
    q.j[e] = nz ? __ffs(nz) - 1 : 0;
    q.w[e] = nz ? s_lw[e * KT_SUBJ + a] : 0u;
    nz &= nz - 1u;
  }
  q.rest = nz;
}

// does row r (ts t0..t2, kind rk, nonzero-word mask rnz, words at row)
// answer subject q? DENSE: some subject of the tile has more than KT_REG
// nonzero words (its rest ANDed where the row's word is nonzero too)
template <bool DENSE>
__device__ __forceinline__ bool key_hit(const KeySubj& q, int t0, int t1,
                                        int t2, int rk, unsigned rnz,
                                        const unsigned* row) {
  unsigned acc = 0u;
#pragma unroll
  for (int e = 0; e < KT_REG; ++e) acc |= q.w[e] & row[q.j[e]];
  if (DENSE) {
    acc |= rnz & q.full;
    for (unsigned m = q.rest & rnz & ~q.full; m; m &= m - 1u) {
      const int j = __ffs(m) - 1;
      acc |= q.sw[j] & row[j];
    }
  }
  return ((q.wit >> rk) & 1u) && acc != 0u &&
         lex_before(t0, t1, t2, q.b0, q.b1, q.b2);
}

// One warp's valid row words of a tile (every KT_WARPS-th of the words in
// vwm): lane i holds row 32 w + i's ts and kind, the warp's rows' words go
// to rr, and each valid row is walked against the lane's one or two owned
// subjects; each subject's packed word goes to s_out[a * KT_OUT + wl].
template <bool DENSE>
__device__ __forceinline__ void key_walk(
    const KeySubj& q0, const KeySubj& q1, bool two, unsigned vwm, int w0,
    int nact, const unsigned* __restrict__ act_bm, int bm_stride,
    const int* __restrict__ act_ts, const int* __restrict__ act_kinds,
    int nw, int nk, int rs, unsigned* rr, const unsigned* s_vm,
    unsigned* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int k = 0;
  for (unsigned mw = vwm; mw; mw &= mw - 1u, ++k) {
    if (k % KT_WARPS != warp) continue;              // warp-uniform
    const int wl = __ffs(mw) - 1;
    const int row = ((w0 + wl) << 5) + lane;
    const int t0 = act_ts[row * 3], t1 = act_ts[row * 3 + 1],
              t2 = act_ts[row * 3 + 2];
    int ak = act_kinds[row];
    if (ak < 0) ak += nk;
    ak = min(max(ak, 0), nk - 1);
    __syncwarp();                        // the last word's reads of rr
    const unsigned* src = act_bm + (long long)((w0 + wl) << 5) * bm_stride;
    unsigned x[32], rnz = 0u;            // lane r: row r's nonzero words
#pragma unroll
    for (int r = 0; r < 32; ++r)
      x[r] = lane < nw ? src[(long long)r * bm_stride + lane] : 0u;
    if (lane < nw) {
#pragma unroll
      for (int r = 0; r < 32; ++r) rr[r * rs + lane] = x[r];
    }
    if (DENSE) {
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const unsigned b = __ballot_sync(0xffffffffu, x[r] != 0u);
        if (lane == r) rnz = b;
      }
    }
    __syncwarp();
    unsigned word0 = 0u, word1 = 0u;
    // two valid rows a step (independent chains); a lone last row is
    // walked twice, its second bit masked off
    for (unsigned m = s_vm[wl]; m;) {
      const int ra = __ffs(m) - 1;                   // uniform
      m &= m - 1u;
      const int rb = m ? __ffs(m) - 1 : ra;
      const unsigned bb = m ? 1u << rb : 0u;
      m &= m - 1u;
      const int a0 = __shfl_sync(0xffffffffu, t0, ra);
      const int a1 = __shfl_sync(0xffffffffu, t1, ra);
      const int a2 = __shfl_sync(0xffffffffu, t2, ra);
      const int ka = __shfl_sync(0xffffffffu, ak, ra);
      const int b0 = __shfl_sync(0xffffffffu, t0, rb);
      const int b1 = __shfl_sync(0xffffffffu, t1, rb);
      const int b2 = __shfl_sync(0xffffffffu, t2, rb);
      const int kb = __shfl_sync(0xffffffffu, ak, rb);
      unsigned na = 0u, nb = 0u;
      if (DENSE) {
        na = __shfl_sync(0xffffffffu, rnz, ra);
        nb = __shfl_sync(0xffffffffu, rnz, rb);
      }
      const unsigned* wa = rr + ra * rs;
      const unsigned* wb = rr + rb * rs;
      if (key_hit<DENSE>(q0, a0, a1, a2, ka, na, wa)) word0 |= 1u << ra;
      if (key_hit<DENSE>(q0, b0, b1, b2, kb, nb, wb)) word0 |= bb;
      if (two) {
        if (key_hit<DENSE>(q1, a0, a1, a2, ka, na, wa)) word1 |= 1u << ra;
        if (key_hit<DENSE>(q1, b0, b1, b2, kb, nb, wb)) word1 |= bb;
      }
    }
    if (lane < nact) s_out[lane * KT_OUT + wl] = word0;
    if (two && lane + 32 < nact) s_out[(lane + 32) * KT_OUT + wl] = word1;
  }
}

// The block body: blockIdx.z is the tile's group of gw row words,
// blockIdx.x its run of subject tiles (blockIdx.y the caller's block; the
// caller returns before it for a group past the block's cap). Row r's nw bucket words start at act_bm +
// r * bm_stride (bm_stride == nw for a whole arena; a mesh shard reads its
// 'model' word slice of a wider arena in place); subject s's at
// subj_words + s * nw. subj_store == nullptr: no slot mask (single store);
// else subject s is this block's when subj_store[s] == slot (and, with a
// gate, subj_gate[s] != 0). Every thread reaches every barrier: the early
// exits are whole-CTA decisions taken on barrier results.
__device__ __forceinline__ void resolve_body(
    const unsigned* __restrict__ subj_words,
    const int* __restrict__ subj_before, const int* __restrict__ subj_kinds,
    const int* __restrict__ subj_store, int slot,
    const unsigned char* __restrict__ subj_gate, int b,
    const unsigned* __restrict__ act_bm, int bm_stride,
    const int* __restrict__ act_ts, const int* __restrict__ act_kinds,
    const unsigned char* __restrict__ act_valid, int cap, int nw,
    const int* __restrict__ witness, int nk, unsigned* __restrict__ out,
    int out_stride, int out_off, int gw) {
  extern __shared__ int4 key_smem[];
  int4* s_info = key_smem;                              // by tile subject
  unsigned* s_out = (unsigned*)(s_info + KT_SUBJ);      // [KT_SUBJ][KT_OUT]
  unsigned* s_lw = s_out + KT_SUBJ * KT_OUT;            // [KT_REG][KT_SUBJ]
  unsigned* s_rows = s_lw + KT_SUBJ * KT_REG;           // [KT_WARPS][32][rs]
  const int rs = key_row_stride(nw);
  __shared__ int s_wit[64];
  __shared__ int s_pos[KT_SUBJ];   // -2 owned (before the lists), else its
  __shared__ unsigned s_nzm[KT_SUBJ];  // list's index or -1; each list's
  __shared__ unsigned s_fm[KT_SUBJ];   // nonzero and all-ones words, its
  __shared__ int s_sub[KT_SUBJ];   // subject; the valid
  __shared__ unsigned s_vm[KT_WORDS];  // rows of each row word; lists made
  __shared__ int s_nact;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (b + KT_SUBJ - 1) / KT_SUBJ;
  const int tyn = (tiles + gridDim.x - 1) / gridDim.x;
  const int t_first = blockIdx.x * tyn;
  const int w0 = blockIdx.z * gw;
  const int tw = min(gw, (cap >> 5) - w0);
  unsigned* const dst = out + out_off + w0;

  // 1. ownership of every tile of the run, one bit a tile
  unsigned own = 0u;
  if (tid < KT_SUBJ) {
#pragma unroll
    for (int ty = 0; ty < KT_TY; ++ty) {
      const int s = (t_first + ty) * KT_SUBJ + tid;
      if (ty < tyn && s < b &&
          (subj_store == nullptr || subj_store[s] == slot) &&
          (subj_gate == nullptr || subj_gate[s] != 0))
        own |= 1u << ty;
    }
  }
  bool wit_loaded = false;
  for (int ty = 0; ty < tyn; ++ty) {
    const int s0 = (t_first + ty) * KT_SUBJ;
    if (s0 >= b) break;                                 // uniform
    const int ns = min(KT_SUBJ, b - s0);
    const int mine = (own >> ty) & 1;
    if (tid < KT_SUBJ) s_pos[tid] = mine ? -2 : -1;
    if (tid == 0) s_nact = 0;
    if (!__syncthreads_or(mine)) {
      key_store_tile(dst, out_stride, s0, ns, tw, nullptr, nullptr);
      continue;
    }

    // 2. the owned subjects, every load issued before any is used: a
    // thread a subject reads its bound and kind, a warp a subject its
    // words (ballot: the nonzero ones, a popc prefix: the first KT_REG's
    // slots),
    // and a thread 8 rows' valid bytes (ballot: each row word's valid rows)
    if (!wit_loaded && tid < nk * nk) s_wit[tid] = witness[tid];
    wit_loaded = true;
    if (mine) {
      int kd = subj_kinds[s0 + tid];
      if (kd < 0) kd += nk;                 // a jnp gather: wrap, then clamp
      kd = min(max(kd, 0), nk - 1);
      const int* bf = subj_before + (long long)(s0 + tid) * 3;
      s_info[tid] = make_int4(bf[0], bf[1], bf[2], kd);
    }
    unsigned v[KT_SUBJ / KT_WARPS];
#pragma unroll
    for (int k = 0; k < KT_SUBJ / KT_WARPS; ++k) {
      const int s = warp + k * KT_WARPS;
      v[k] = s < ns && lane < nw && s_pos[s] == -2
                 ? subj_words[(long long)(s0 + s) * nw + lane]
                 : 0u;
    }
    unsigned vr[KT_WORDS * 32 / KT_THREADS];
#pragma unroll
    for (int i = 0; i < KT_WORDS * 32 / KT_THREADS; ++i) {
      const int r = i * KT_THREADS + tid;             // of the tile's rows
      vr[i] = r < tw * 32 ? act_valid[(w0 << 5) + r] : 0u;
    }
#pragma unroll
    for (int i = 0; i < KT_WORDS * 32 / KT_THREADS; ++i) {
      const unsigned m = __ballot_sync(0xffffffffu, vr[i] != 0u);
      if (lane == 0) s_vm[i * KT_WARPS + warp] = m;
    }
#pragma unroll
    for (int k = 0; k < KT_SUBJ / KT_WARPS; ++k) {
      const int s = warp + k * KT_WARPS;
      if (s >= ns || s_pos[s] != -2) continue;         // warp-uniform
      const unsigned nz = __ballot_sync(0xffffffffu, v[k] != 0u);
      const unsigned fm = __ballot_sync(0xffffffffu, v[k] == 0xffffffffu);
      int a = -1;
      if (nz) {
        if (lane == 0) a = atomicAdd(&s_nact, 1);
        a = __shfl_sync(0xffffffffu, a, 0);
        const int p = __popc(nz & ((1u << lane) - 1u));
        if (v[k] && p < KT_REG) s_lw[p * KT_SUBJ + a] = v[k];
        if (lane == 0) {
          s_nzm[a] = nz;
          s_fm[a] = fm;
          s_sub[a] = s;
        }
      }
      if (lane == 0) s_pos[s] = a;                     // no key: -1, zero
    }
    __syncthreads();
    const int nact = s_nact;
    if (nact > 0) {
      // 3. a warp a valid row word (lane i: row 32 w + i; the valid words
      // dealt round the warps), one or two owned subjects a lane, packed
      // into s_out[a * KT_OUT + wl]; a word with no valid row is zero
      KeySubj q0, q1;
      key_subj_load(q0, lane, nact, s_info, s_sub, s_nzm, s_fm, s_lw, s_wit,
                    nk, subj_words, s0, nw);
      const bool two = nact > 32;                      // uniform
      if (two)
        key_subj_load(q1, lane + 32, nact, s_info, s_sub, s_nzm, s_fm, s_lw,
                      s_wit, nk, subj_words, s0, nw);
      // a subject with more than KT_REG nonzero words: rows' masks wanted
      const bool dense = __syncthreads_or((two ? q0.rest | q1.rest
                                               : q0.rest) != 0u);
      const unsigned vwm =
          __ballot_sync(0xffffffffu, lane < tw && s_vm[lane] != 0u);
      for (int wl = warp; wl < tw; wl += KT_WARPS) {
        if ((vwm >> wl) & 1u) continue;
        if (lane < nact) s_out[lane * KT_OUT + wl] = 0u;
        if (lane + 32 < nact) s_out[(lane + 32) * KT_OUT + wl] = 0u;
      }
      unsigned* rr = s_rows + warp * 32 * rs;
      if (dense)
        key_walk<true>(q0, q1, two, vwm, w0, nact, act_bm, bm_stride, act_ts,
                       act_kinds, nw, nk, rs, rr, s_vm, s_out);
      else
        key_walk<false>(q0, q1, two, vwm, w0, nact, act_bm, bm_stride, act_ts,
                        act_kinds, nw, nk, rs, rr, s_vm, s_out);
    }
    __syncthreads();

    // 4. the staged tile out
    key_store_tile(dst, out_stride, s0, ns, tw, s_out, s_pos);
    __syncthreads();             // the next tile rewrites s_pos and s_out
  }
}

__global__ void __launch_bounds__(KT_THREADS, KT_MIN_CTAS)
resolve_kernel(const unsigned* __restrict__ subj_words,
               const int* __restrict__ subj_before,
               const int* __restrict__ subj_kinds,
               const int* __restrict__ subj_store,
               const int* __restrict__ slot_ptr,
               const unsigned char* __restrict__ subj_gate, int b,
               const unsigned* __restrict__ act_bm, int bm_stride,
               const int* __restrict__ act_ts,
               const int* __restrict__ act_kinds,
               const unsigned char* __restrict__ act_valid, int cap, int nw,
               const int* __restrict__ witness, int nk,
               unsigned* __restrict__ out, int out_stride, int out_off,
               int gw) {
  resolve_body(subj_words, subj_before, subj_kinds, subj_store,
               slot_ptr == nullptr ? 0 : *slot_ptr, subj_gate, b, act_bm,
               bm_stride, act_ts, act_kinds, act_valid, cap, nw, witness, nk,
               out, out_stride, out_off, gw);
}

// one key body over one block: grid (row-word groups, subject tiles)
static inline int launch_resolve(
    const void* subj_words, const void* subj_before, const void* subj_kinds,
    const void* subj_store, const void* slot, const void* gate, int b,
    const void* act_bm, int bm_stride, const void* act_ts,
    const void* act_kinds, const void* act_valid, int cap, int nw,
    const void* witness, int nk, void* out, int out_stride, int out_off,
    cudaStream_t st) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31) || bm_stride < nw)
    return (int)cudaErrorInvalidValue;
  if (cap == 0 || b <= 0) return 0;
  const KeyGeom g = key_geom(cap, b, nw, 1);
  resolve_kernel<<<g.grid, g.threads, g.smem, st>>>(
      (const unsigned*)subj_words, (const int*)subj_before,
      (const int*)subj_kinds, (const int*)subj_store, (const int*)slot,
      (const unsigned char*)gate, b, (const unsigned*)act_bm, bm_stride,
      (const int*)act_ts, (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, out_stride, out_off, g.gw);
  ACCORD_CHECK();
  return 0;
}
