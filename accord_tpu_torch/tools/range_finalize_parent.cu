// The parent's K6 (csrc/range_finalize.cu before its redesign), kept to
// time it beside the shipped one on the same card in the same process:
// tools/range_finalize_variants.py (and chip_smoke.py) builds this file
// alone and binds its entry, whose C signature is the shipped one, in
// place of the shipped library's. Not built by ops/_ext.py.
//
// Two launches: one warp per (entry, 32-row word) builds the packed word
// of m with `__ballot_sync`, adds the stab word's popcount to the bound
// with a global atomic (in the compaction's zeroed scratch) and writes the
// word to a global scratch u32[NV, rcap/32]; then K2's compaction kernel
// (common.cuh's csr_kernel, its tiled form at every size, as the parent
// launched it) reads the words back. It is built on the shipped
// common.cuh, so the pair times K6's own change: the stab words built
// inside the compaction's tiles, and the one-block form of small calls.
// The word scratch is this file's own device buffer, grown only outside a
// graph capture (and never freed, so a graph captured over it stays
// valid).
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

// where the stab kernel adds to the one spec's bound (the compaction's
// scratch: a CsrHdr, then the spec's CsrAcc)
static inline int* csr_bound_slot(void* scratch) {
  return &((CsrAcc*)((char*)scratch + sizeof(CsrHdr)))->bound;
}

static unsigned* g_words = nullptr;
static size_t g_words_bytes = 0;

// the stab-word scratch: at least `bytes`, grown only outside a capture
static int words_scratch(size_t bytes, cudaStream_t st, unsigned** out) {
  if (bytes > g_words_bytes) {
    cudaStreamCaptureStatus cs = cudaStreamCaptureStatusNone;
    cudaStreamIsCapturing(st, &cs);
    if (cs != cudaStreamCaptureStatusNone) return (int)cudaErrorInvalidValue;
    void* p = nullptr;
    const size_t want = bytes < (16u << 20) ? (16u << 20) : bytes;
    cudaError_t e = cudaMalloc(&p, want);
    if (e != cudaSuccess) return (int)e;
    g_words = (unsigned*)p;
    g_words_bytes = want;
  }
  *out = g_words;
  return 0;
}

// the shipped signature; scratch as segment_compact's over nv x rcap/32
// words
extern "C" int range_finalize_csr(
    const void* iv_of, const void* iv_s, const void* iv_e, const void* ent_ok,
    int nv, const void* subj_before, const void* subj_kinds, int b,
    const void* r_start, const void* r_end, const void* r_ts,
    const void* r_kinds, const void* r_valid, int rcap, const void* witness,
    int nk, int out_cap, void* indptr, void* dep_rows, void* dep_ts,
    void* bound, void* csum, void* scratch, void* stream) {
  if ((rcap & 31) || b <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* words = nullptr;
  const int rc = words_scratch((size_t)nv * (rcap >> 5) * 4 + 4, st, &words);
  if (rc != 0) return rc;
  const long long threads = (long long)nv * (rcap >> 5) * 32;
  if (threads > 0) {
    stab_words_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int*)iv_of, (const int*)iv_s, (const int*)iv_e,
        (const unsigned char*)ent_ok, nv, (const int*)subj_before,
        (const int*)subj_kinds, b, (const int*)r_start, (const int*)r_end,
        (const int*)r_ts, (const int*)r_kinds, (const unsigned char*)r_valid,
        rcap, (const int*)witness, nk, words, csr_bound_slot(scratch));
    ACCORD_CHECK();
  }
  CsrOne<WordsIn> tab;
  tab.s_ = WordsIn{words, rcap >> 5};
  tab.o_ = csr_out_one(nv, rcap >> 5, (const int*)r_ts, out_cap,
                       (int*)indptr, (int*)dep_rows, (int*)dep_ts,
                       (int*)bound, (unsigned*)csum, scratch,
                       FoldSeeds{1u, 5u, 9u});
  tab.ctiles = tab.o_.ntiles;
  tab.tiles = tab.o_.ntiles + tab.o_.npad;
  tab.nspec = 1;
  tab.state = tab.o_.state;
  csr_kernel<CsrOne<WordsIn>><<<csr_grid(tab.tiles), CT, 0, st>>>(
      tab, (CsrHdr*)scratch);
  ACCORD_CHECK();
  return 0;
}
