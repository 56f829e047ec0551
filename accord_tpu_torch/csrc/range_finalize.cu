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
//   m[e, r]    = stab & witness[subj_kind[o], r_kind] == 1
//                & r_ts <lex subj_before[o]
//                with o = clip(iv_of[e], 0, B - 1); kinds wrap once if
//                negative, then clamp, as jnp gathers do
// and the set bits of m, in (entry, row) order, compact to the CSR
// (indptr i32[NV+1], dep_rows i32[out_cap], dep_ts = r_ts[dep_rows]
// i32[out_cap, 3], padding row 0 / r_ts[0] past the total, indptr[NV] past
// out_cap on overflow) with the finalize checksum over the whole arrays.
//
// The JAX kernel materialises the dense [NV, rcap] 0/1 matrix and
// compacts it with a scatter. Here ONE launch and no memset: K2's
// compaction (common.cuh's launch_csr) over a source that builds each
// compaction tile's packed words of m and of stab in shared memory (its
// `stage`), so no word reaches global memory; the stab words' popcounts are
// the tile's bound contribution, summed a block by the compaction's own
// bound path. A tile's RF_TW (512) words are (entry, row word) pairs in
// flat order: half K2's tiles, so at the range batch every resident block
// of the launch builds words before the pad tiles begin.
// The tile first loads its entries once (the interval, the gathered
// subject's before lanes, and its witness row as a bit mask over row kinds,
// built from the witness table in shared memory; an entry out of bounds
// or not ok gets an iv_start no row can stab), then a warp takes a column
// of the tile -- the words of one row word wd across the tile's entries
// -- with a lane a row of wd, its five lanes loaded once into registers,
// and builds each word of the column with a ballot of stab and, where any
// lane stabs, one of m; a warp takes two columns at once. A tile of few
// columns (rcap 32 to 224) splits each column's entries over several
// warps. The dense column order is the packed bit order, so the outputs
// are the JAX kernel's.
//
// What bounds it: bytes -- the outputs (out_cap rows, padded), the lanes;
// the compares are a few per (entry, row), on registers and broadcast
// shared loads.
#include <limits.h>

#include "common.cuh"

struct WordsIn {
  const unsigned* words;
  int w;

  __device__ __forceinline__ unsigned word(int, int, long long f,
                                           unsigned* kw) const {
    *kw = 0u;  // segment_compact has no bound
    return words[f];
  }
};

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

#define RF_CI 2        // words a thread: compaction tiles of CT * RF_CI words
#define RF_TW (CT * RF_CI)
#define RF_E (RF_TW + 1)  // entries a tile can touch (a word each, +1 ragged)
#define RF_NK 16       // most witness kinds (a thread an entry of the table)
#define RF_NW (CT / 32)
static_assert(RF_NK * RF_NK <= CT, "a thread an entry of the witness table");

// one tile's staged entries and built words
struct RfSmem {
  int4 e4[RF_E];        // iv_start (INT_MAX: stabs nothing), iv_end, the
                        // witness row (bit k: witness[sk, k] == 1), sb0
  int2 e2[RF_E];        // sb1, sb2
  unsigned wrow[RF_NK]; // the witness rows by subject kind
  unsigned m[RF_TW], s[RF_TW];  // the tile's masked words and stab words
};

// at namespace scope, so every access compiles to a shared-memory load or
// store (the one kernel that stages these words allocates it)
__shared__ RfSmem rf_sm;

__device__ __forceinline__ int rf_kind(int k, int nk) {
  if (k < 0) k += nk;  // a jnp gather: wrap once, then clamp
  return min(max(k, 0), nk - 1);
}

// a lane's row of a column: its start (INT_MAX where the row is invalid:
// it stabs nothing), end, kind as a bit, ts
struct RfRow {
  int rs, re;
  unsigned kbit;
  int t0, t1, t2;
};

struct StabIn {
  const int* iv_of;
  const int* iv_s;
  const int* iv_e;
  const unsigned char* ent_ok;
  const int* subj_before;
  const int* subj_kinds;
  int b;
  const int* r_start;
  const int* r_end;
  const int* r_ts;
  const int* r_kinds;
  const unsigned char* r_valid;
  const int* witness;
  int nk;
  int w;  // row words: rcap / 32
  static constexpr int ci = RF_CI;

  __device__ __forceinline__ RfRow row(long long f0, int lane) const {
    const int r = (int)(f0 % w) * 32 + lane;
    RfRow x;
    x.rs = r_valid[r] != 0 ? r_start[r] : INT_MAX;
    x.re = r_end[r];
    x.kbit = 1u << rf_kind(r_kinds[r], nk);
    x.t0 = r_ts[3 * r];
    x.t1 = r_ts[3 * r + 1];
    x.t2 = r_ts[3 * r + 2];
    return x;
  }

  // the words [base, base + min(RF_TW, n - base)) of m and stab, in shared
  // memory (every thread of the block). Column c of the tile is its words
  // c, c + w, c + 2w, ... (row word (base + c) % w of consecutive
  // entries); `slices` warps share a column when there are fewer columns
  // than warps, else a warp takes two columns at a time. Every global load
  // that waits on nothing (the witness, the entries' lanes, the warp's
  // first rows) is issued first.
  __device__ __forceinline__ void stage(long long base, long long n) const {
    const int nt = (int)min((long long)RF_TW, n - base);
    const int e0 = (int)(base / w);
    const int ne = (int)((base + nt - 1) / w) - e0 + 1;
    const int cols = min(w, nt);
    const int slices = cols >= RF_NW ? 1 : RF_NW / cols;
    const int items = cols * slices;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = threadIdx.x;
    const int wv = t < nk * nk ? witness[t] : 0;
    RfRow ra = warp < items ? row(base + warp % cols, lane) : RfRow{};
    int of = 0, is = 0, ie = 0;
    bool ok = false;
    if (t < ne) {  // the thread's first entry
      of = iv_of[e0 + t];
      is = iv_s[e0 + t];
      ie = iv_e[e0 + t];
      ok = ent_ok[e0 + t] != 0;
    }
    if (t < RF_NK) rf_sm.wrow[t] = 0u;
    __syncthreads();
    if (t < nk * nk && wv == 1) atomicOr(&rf_sm.wrow[t / nk], 1u << (t % nk));
    for (int q = t; q < ne; q += CT) {
      if (q != t) {
        const int e = e0 + q;
        of = iv_of[e];
        is = iv_s[e];
        ie = iv_e[e];
        ok = ent_ok[e] != 0;
      }
      const bool inb = of >= 0 && of < b && ok;
      const int o = min(max(of, 0), b - 1);
      const int sk = rf_kind(subj_kinds[o], nk);
      rf_sm.e4[q] = make_int4(inb ? is : INT_MAX, ie, sk, subj_before[3 * o]);
      rf_sm.e2[q] = make_int2(subj_before[3 * o + 1], subj_before[3 * o + 2]);
    }
    __syncthreads();
    for (int q = t; q < ne; q += CT)
      rf_sm.e4[q].z = (int)rf_sm.wrow[rf_sm.e4[q].z];
    __syncthreads();
    for (int it = warp; it < items; it += 2 * RF_NW) {
      const int it2 = it + RF_NW;
      const bool two = it2 < items;
      if (it != warp) ra = row(base + it % cols, lane);
      const RfRow rb = two ? row(base + it2 % cols, lane) : RfRow{};
      const int ca = it % cols, sa = it / cols;
      const int cb = it2 % cols, sb = it2 / cols;
      const int qa0 = (int)((base + ca) / w) - e0 + sa;
      const int qb0 = (int)((base + cb) / w) - e0 + sb;
      for (int kk = 0;; ++kk) {
        const int ja = ca + (sa + kk * slices) * w;
        const int jb = cb + (sb + kk * slices) * w;
        const bool va = ja < nt, vb = two && jb < nt;
        if (!va && !vb) break;
        const int qa = qa0 + kk * slices, qb = qb0 + kk * slices;
        const int4 xa = va ? rf_sm.e4[qa] : make_int4(INT_MAX, 0, 0, 0);
        const int4 xb = vb ? rf_sm.e4[qb] : make_int4(INT_MAX, 0, 0, 0);
        const bool sta = xa.x < ra.re && ra.rs < xa.y;
        const bool stb = xb.x < rb.re && rb.rs < xb.y;
        const unsigned swa = __ballot_sync(0xffffffffu, sta);
        const unsigned swb = __ballot_sync(0xffffffffu, stb);
        unsigned mwa = 0u, mwb = 0u;
        if (swa | swb) {
          const int2 ya = va ? rf_sm.e2[qa] : make_int2(0, 0);
          const int2 yb = vb ? rf_sm.e2[qb] : make_int2(0, 0);
          mwa = __ballot_sync(0xffffffffu,
                              sta && ((unsigned)xa.z & ra.kbit) &&
                                  lex_before(ra.t0, ra.t1, ra.t2, xa.w,
                                             ya.x, ya.y));
          mwb = __ballot_sync(0xffffffffu,
                              stb && ((unsigned)xb.z & rb.kbit) &&
                                  lex_before(rb.t0, rb.t1, rb.t2, xb.w,
                                             yb.x, yb.y));
        }
        if (lane == 0) {
          if (va) {
            rf_sm.s[ja] = swa;
            rf_sm.m[ja] = mwa;
          }
          if (vb) {
            rf_sm.s[jb] = swb;
            rf_sm.m[jb] = mwb;
          }
        }
      }
    }
    __syncthreads();
  }

  __device__ __forceinline__ unsigned word(int, int, long long f,
                                           unsigned* kw) const {
    const int j = (int)(f & (RF_TW - 1));  // tiles start at multiples of it
    *kw = rf_sm.s[j];
    return rf_sm.m[j];
  }
};

// the words a compaction tile of range_finalize_csr (its scratch holds a
// state word a tile: kernels.csr_sizes()[2])
extern "C" int range_finalize_tile_words() { return RF_TW; }

// ONE launch; scratch: kernels.csr_scratch_bytes(1, tiles of nv x rcap/32
// words at range_finalize_tile_words() a tile) zeroed bytes, left zeroed
extern "C" int range_finalize_csr(
    const void* iv_of, const void* iv_s, const void* iv_e, const void* ent_ok,
    int nv, const void* subj_before, const void* subj_kinds, int b,
    const void* r_start, const void* r_end, const void* r_ts,
    const void* r_kinds, const void* r_valid, int rcap, const void* witness,
    int nk, int out_cap, void* indptr, void* dep_rows, void* dep_ts,
    void* bound, void* csum, void* scratch, void* stream) {
  if ((rcap & 31) || b <= 0 || nk <= 0 || nk > RF_NK)
    return (int)cudaErrorInvalidValue;
  StabIn in{(const int*)iv_of,        (const int*)iv_s,
            (const int*)iv_e,         (const unsigned char*)ent_ok,
            (const int*)subj_before,  (const int*)subj_kinds,
            b,                        (const int*)r_start,
            (const int*)r_end,        (const int*)r_ts,
            (const int*)r_kinds,      (const unsigned char*)r_valid,
            (const int*)witness,      nk,
            rcap >> 5};
  return launch_csr(in, nv, (const int*)r_ts, out_cap, (int*)indptr,
                    (int*)dep_rows, (int*)dep_ts, (int*)bound,
                    (unsigned*)csum, scratch, (cudaStream_t)stream);
}
