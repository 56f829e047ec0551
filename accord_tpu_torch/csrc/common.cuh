// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a).
//
// Conventions every kernel here keeps, so that each one matches its JAX
// reference bit for bit:
//   * packed row sets are 32-bit words, row 32*w + i in bit i of word w
//     (lowest row in the least significant bit); torch carries them as
//     int32 bit patterns, the kernels read them as unsigned;
//   * scatter indices follow jnp's `.at[]` rules: a negative index counts
//     from the end (i + n), and whatever is still outside [0, n) is
//     dropped, never written (padding sentinels such as cap, B or KC);
//   * each C entry point launches on the stream it is given, allocates
//     nothing, and returns cudaGetLastError() so the caller can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define ACCORD_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return (int)e_;               \
  } while (0)

extern "C" const char* accord_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// jnp .at[] index normalisation: -1 is the last element; -1 result = drop
__device__ __forceinline__ int norm_index(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// a < b lexicographically over three signed int32 lanes
__device__ __forceinline__ bool lex_before(int a0, int a1, int a2,
                                           int b0, int b1, int b2) {
  return (a0 < b0) || (a0 == b0 && ((a1 < b1) || (a1 == b1 && a2 < b2)));
}

// grid-stride copy of n elements
template <typename T>
__global__ void copy_kernel(T* __restrict__ dst, const T* __restrict__ src,
                            long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    dst[i] = src[i];
}

static inline int grid_for(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 8192) g = 8192;
  return (int)g;
}

// 16-byte vectors where both pointers and the size allow, else elements
template <typename T>
static inline void launch_copy(T* dst, const T* src, long long n,
                               cudaStream_t st) {
  if (n <= 0) return;
  long long bytes = n * (long long)sizeof(T);
  if (((uintptr_t)dst % 16 == 0) && ((uintptr_t)src % 16 == 0) &&
      bytes % 16 == 0) {
    long long nv = bytes / 16;
    copy_kernel<uint4><<<grid_for(nv, 256), 256, 0, st>>>(
        (uint4*)dst, (const uint4*)src, nv);
  } else {
    copy_kernel<T><<<grid_for(n, 256), 256, 0, st>>>(dst, src, n);
  }
}

// ---------------------------------------------------------------------------
// Segment compaction of packed row words into a CSR (K2 finalize_csr, K6
// range_finalize / segment_compact, K9's compact entry, K11): ONE launch,
// one pass over the words, no memset. A source `Src` exposes `int w` (words
// per segment) and `unsigned word(int sg, int wd, long long f, unsigned*
// kw) const`, the masked word wd of segment sg (flat index f = sg * w +
// wd), with *kw its bound contribution (0 where the caller counts the
// bound elsewhere). The set bits, in (segment, row) order, are the output
// rows. A source may also expose `void stage(long long base, long long n)
// const`, which every thread of the block calls at the start of each
// compaction tile (base its first flat word, n the spec's words): it builds
// the tile's words in shared memory, and `word` reads them there (K6
// computes its stab words so, never writing them to global memory).
//
// A launch runs over one or more SPECS (a spec: a source, its outputs and
// its scratch). Its tiles are numbered in order: every spec's compaction
// tiles (CW consecutive words each), then every spec's pad tiles (CW output
// positions each). A block takes tile ids from an atomic counter, so a
// tile is only taken by a block that is running, and every lower id is
// taken already: that is what lets a tile wait on lower tiles.
//   * a compaction tile popcounts its masked words (CI consecutive words a
//     thread) and scans them in the block; publishes its aggregate, then
//     looks back over its predecessors' published words (decoupled
//     look-back, one warp reading 32 at a time) for its offset, and
//     publishes its inclusive prefix; it writes its set bits below out_cap
//     (and dep_ts, gathered from ts), indptr at each segment's first word,
//     and -- the spec's last tile -- indptr[S], the exact total;
//   * a pad tile waits for the spec's total (its last compaction tile's
//     inclusive prefix) and writes the padding past it: row 0, ts[0];
//   * whoever writes a value folds it into the checksum: wrapping u32
//     partial sums added atomically, whose order cannot change the word;
//     the bound is an exact int atomic sum;
//   * the block that finishes last (an atomic ticket) writes each spec's
//     checksum and bound and leaves every scratch word zero again, so the
//     next launch on the stream -- or the next replay of a graph -- finds
//     it as the first did.
// Scratch of a launch, zeroed once when allocated: a CsrHdr, a CsrAcc per
// spec, and a tile state (u64: flag << 32 | value) per compaction tile.
// The grid is at most four blocks an SM; correctness does not depend on
// how many blocks are resident, because a block waits only on tiles that
// running blocks have taken.
#define CT 256          // threads per block
#define CI 4            // consecutive words per thread
#define CW (CT * CI)    // words per compaction tile
#define CP (4 * CW)     // positions per pad tile

// the compaction's tile width and pad tile width, for the wrappers'
// scratch sizes and a table launch's tile numbers
extern "C" int csr_tile_words() { return CW; }
extern "C" int csr_pad_positions() { return CP; }

struct CsrHdr {
  unsigned taken, done, unused0, unused1;
};

struct CsrAcc {
  unsigned fold[3];  // indptr, dep_rows, dep_ts partial sums
  int bound;
};

// the odd offsets of the checksum's position multipliers, per lane:
// indptr, dep_rows, dep_ts (finalize: 1 / 5 / 9; frontier: 13 / 17 / -)
struct FoldSeeds {
  unsigned i, r, t;
};

// one spec's outputs, scratch and tiles (tile ids global to the launch)
struct CsrOut {
  const int* ts;               // dep_ts rows, or null: no dep_ts lane
  int* indptr;
  int* dep_rows;
  int* dep_ts;
  int* bound;                  // or null: no bound output
  unsigned* csum;              // or null: no checksum
  CsrAcc* acc;
  unsigned long long* state;   // this spec's compaction tiles' states
  long long n;                 // words: s * w
  int s, w, out_cap;
  int tile0, ntiles, pad0, npad;
  FoldSeeds seeds;
};

// compaction tiles of tw words each over n words
static inline int csr_tiles_for(long long n, int tw = CW) {
  return (int)((n + tw - 1) / tw);
}

static inline int csr_pads_for(int out_cap) {
  const int p = (out_cap + CP - 1) / CP;
  return p < 1 ? 1 : p;   // pad tile 0 also writes indptr when n == 0
}

// block-wide exclusive scan of one int per thread (CT threads); *total =
// the block sum
__device__ __forceinline__ int block_excl_scan(int x, int* total) {
  __shared__ int warp_sums[CT / 32];
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
    int v = lane < CT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < CT / 32) warp_sums[lane] = v;  // inclusive warp prefix
  }
  __syncthreads();
  int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[CT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

__device__ __forceinline__ unsigned fold_term(int x, unsigned idx,
                                              unsigned seed) {
  unsigned v = (unsigned)x;
  v ^= v >> 16;
  return v * (2u * idx + seed);
}

// three wrapping u32 block sums (blockDim.x <= 1024), valid in thread 0
__device__ __forceinline__ void block_sum3(unsigned& a, unsigned& b,
                                           unsigned& c) {
  __shared__ unsigned part[3][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, d);
    b += __shfl_down_sync(0xffffffffu, b, d);
    c += __shfl_down_sync(0xffffffffu, c, d);
  }
  if (lane == 0) {
    part[0][warp] = a;
    part[1][warp] = b;
    part[2][warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane < (int)(blockDim.x >> 5);
    a = in ? part[0][lane] : 0u;
    b = in ? part[1][lane] : 0u;
    c = in ? part[2][lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, d);
      b += __shfl_down_sync(0xffffffffu, b, d);
      c += __shfl_down_sync(0xffffffffu, c, d);
    }
  }
  __syncthreads();  // part is reused by the next call
}

// a tile state: the flag in the high word, the count in the low
#define CSR_AGG 1ull   // the tile's own aggregate
#define CSR_PRE 2ull   // its inclusive prefix

// a state word is self-contained (flag and count in one 64-bit access), so
// relaxed device-scope accesses suffice: no other write has to be seen
// with it, and an acquire would drop the spinning SM's L1 on every poll
__device__ __forceinline__ unsigned long long csr_ld(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void csr_st(unsigned long long* p,
                                       unsigned long long flag, int v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p),
               "l"((flag << 32) | (unsigned)v)
               : "memory");
}

// warp 0: publish tile t's aggregate, look back for its exclusive prefix,
// publish its inclusive prefix; returns the exclusive prefix (all lanes)
__device__ __forceinline__ int csr_look_back(unsigned long long* st, int t,
                                             int agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) csr_st(st, CSR_PRE, agg);
    return 0;
  }
  if (lane == 0) csr_st(st + t, CSR_AGG, agg);
  int excl = 0;
  for (int j = t - 1;; j -= 32) {
    const int idx = j - lane;          // lane 0 the nearest predecessor
    unsigned long long w = CSR_PRE << 32;   // before tile 0: a prefix of 0
    if (idx >= 0) {
      do {
        w = csr_ld(st + idx);
      } while ((w >> 32) == 0ull);
    }
    const unsigned pm = __ballot_sync(0xffffffffu, (w >> 32) == CSR_PRE);
    const int lim = pm ? __ffs(pm) - 1 : 31;
    int v = lane <= lim ? (int)(unsigned)w : 0;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    excl += v;
    if (pm) break;
  }
  if (lane == 0) csr_st(st + t, CSR_PRE, excl + agg);
  return excl;
}

// whether a source builds each tile's words first (see above)
template <class S, class = void>
struct csr_staged : std::false_type {};
template <class S>
struct csr_staged<S, std::void_t<decltype(&S::stage)>> : std::true_type {};

// a source's words a thread (`static constexpr int ci`, at most CI): its
// compaction tiles are CT * ci words (CW by default)
template <class S, class = void>
struct csr_ci {
  static constexpr int value = CI;
};
template <class S>
struct csr_ci<S, std::void_t<decltype(S::ci)>> {
  static constexpr int value = S::ci;
};

// compaction tile t of spec o (Solo: the launch's one block runs the
// spec's only tile, so its prefix is 0 and *s_x takes the total)
template <class Src, bool Solo = false>
__device__ __forceinline__ void csr_compact_tile(const Src& src,
                                                 const CsrOut& o, int t,
                                                 int* s_x) {
  constexpr int ci = csr_ci<Src>::value;
  static_assert(ci >= 1 && ci <= CI, "words a thread");
  if constexpr (csr_staged<Src>::value) src.stage((long long)t * CT * ci, o.n);
  const long long base = (long long)t * CT * ci + (long long)threadIdx.x * ci;
  // the thread's first word's segment and word (one division a tile)
  const int sg0 = (int)(base / o.w);
  const int wd0 = (int)(base - (long long)sg0 * o.w);
  unsigned v[ci];
  int cnt = 0, kb = 0;
  {
    int sg = sg0, wd = wd0;
#pragma unroll
    for (int i = 0; i < ci; ++i) {
      unsigned kw = 0u;
      v[i] = base + i < o.n ? src.word(sg, wd, base + i, &kw) : 0u;
      cnt += __popc(v[i]);
      kb += __popc(kw);
      if (++wd == o.w) {
        wd = 0;
        ++sg;
      }
    }
  }
  int agg, kbt;
  const int ex = block_excl_scan(cnt, &agg);
  block_excl_scan(kb, &kbt);
  if (threadIdx.x < 32) {
    const int x = Solo ? 0 : csr_look_back(o.state, t, agg);
    if (threadIdx.x == 0) {
      *s_x = Solo ? agg : x;
      if (o.bound != nullptr && kbt != 0) atomicAdd(&o.acc->bound, kbt);
    }
  }
  if (!Solo) __syncthreads();
  const int x = Solo ? 0 : *s_x;
  int p = x + ex;
  unsigned f1 = 0u, f5 = 0u, f9 = 0u;
  int sg = sg0, wd = wd0;
#pragma unroll
  for (int i = 0; i < ci; ++i, ++wd) {
    if (wd == o.w) {
      wd = 0;
      ++sg;
    }
    if (base + i >= o.n) break;
    if (wd == 0) {
      o.indptr[sg] = p;
      f1 += fold_term(p, (unsigned)sg, o.seeds.i);
    }
    unsigned bits = v[i];
    for (int q = p; bits != 0u && q < o.out_cap; ++q) {
      const int row = (wd << 5) + __ffs(bits) - 1;
      bits &= bits - 1u;
      o.dep_rows[q] = row;
      f5 += fold_term(row, (unsigned)q, o.seeds.r);
      if (o.ts != nullptr) {
#pragma unroll
        for (int l = 0; l < 3; ++l) {
          const int tv = o.ts[3LL * row + l];
          o.dep_ts[3LL * q + l] = tv;
          f9 += fold_term(tv, (unsigned)(3 * q + l), o.seeds.t);
        }
      }
    }
    p += __popc(v[i]);
  }
  if (threadIdx.x == 0 && t == o.ntiles - 1) {
    o.indptr[o.s] = x + agg;   // the exact total, past out_cap too
    f1 += fold_term(x + agg, (unsigned)o.s, o.seeds.i);
  }
  if (o.csum == nullptr) return;   // uniform across the block
  block_sum3(f1, f5, f9);
  if (threadIdx.x == 0) {
    atomicAdd(&o.acc->fold[0], f1);
    atomicAdd(&o.acc->fold[1], f5);
    atomicAdd(&o.acc->fold[2], f9);
  }
}

// x[e] = (a, b, c)[e % 3] for e in [e0, e1), by the block: 16-byte
// stores from the first 16-byte boundary, single ones at either end
__device__ __forceinline__ void csr_fill3(int* x, long long e0, long long e1,
                                          int a, int b, int c) {
  const int v3[5] = {a, b, c, a, b};
  long long va = e0 + (long long)(((16u - ((unsigned)(uintptr_t)(x + e0) &
                                           15u)) & 15u) >> 2);
  if (va > e1) va = e1;
  for (long long e = e0 + threadIdx.x; e < va; e += CT) x[e] = v3[e % 3];
  const long long nv = (e1 - va) >> 2;
  for (long long v = threadIdx.x; v < nv; v += CT) {
    const long long e = va + 4 * v;
    const int m = (int)(e % 3);
    *(int4*)(x + e) = make_int4(v3[m], v3[m + 1], v3[m + 2], v3[m]);
  }
  for (long long e = va + 4 * nv + threadIdx.x; e < e1; e += CT)
    x[e] = v3[e % 3];
}

// pad tile u of spec o: positions [u * CP, (u + 1) * CP) past the total
// (Solo: the total is in *s_x already). The padding's checksum terms sum
// in closed form (the values repeat: sum over positions p of v * (6p + 2l
// + seed)), so the tile only stores.
template <bool Solo = false>
__device__ __forceinline__ void csr_pad_tile(const CsrOut& o, int u,
                                             int* s_x) {
  if (!Solo && threadIdx.x == 0) {
    int total = 0;
    if (o.ntiles > 0) {
      unsigned long long w;
      do {
        w = csr_ld(o.state + o.ntiles - 1);
      } while ((w >> 32) != CSR_PRE);
      total = (int)(unsigned)w;
    }
    *s_x = total;
  }
  __syncthreads();
  const int total = *s_x;
  if (o.ntiles == 0 && u == 0)   // no words: every indptr is 0 (folds 0)
    for (int i = threadIdx.x; i <= o.s; i += CT) o.indptr[i] = 0;
  const int start = min(max(total, 0), o.out_cap);
  const int p0 = max(u * CP, start);
  const int p1 = (int)min((long long)(u + 1) * CP, (long long)o.out_cap);
  if (p0 >= p1) return;            // uniform across the block
  csr_fill3(o.dep_rows, p0, p1, 0, 0, 0);   // row 0 folds to 0
  if (o.ts == nullptr) return;
  const int a = o.ts[0], b = o.ts[1], c = o.ts[2];
  csr_fill3(o.dep_ts, 3LL * p0, 3LL * p1, a, b, c);
  if (o.csum == nullptr || threadIdx.x != 0) return;
  // fold_term(v, 3p + l, seed) summed over p: v' * (6 sum(p) + n (2l + seed))
  const unsigned n = (unsigned)(p1 - p0), t = o.seeds.t;
  const unsigned s6 = 6u * (unsigned)(((long long)p0 + p1 - 1) *
                                      (long long)(p1 - p0) / 2);
  auto hv = [](int v) { return (unsigned)v ^ ((unsigned)v >> 16); };
  atomicAdd(&o.acc->fold[2], hv(a) * (s6 + n * t) +
                                 hv(b) * (s6 + n * (t + 2u)) +
                                 hv(c) * (s6 + n * (t + 4u)));
}

// the last block: each spec's checksum and bound; scratch zeroed again
__device__ __forceinline__ void csr_finish(const CsrOut& o) {
  if (o.csum != nullptr)
    *o.csum = __ldcg(&o.acc->fold[0]) ^ __ldcg(&o.acc->fold[1]) ^
              __ldcg(&o.acc->fold[2]);
  if (o.bound != nullptr) *o.bound = __ldcg(&o.acc->bound);
  o.acc->fold[0] = 0u;
  o.acc->fold[1] = 0u;
  o.acc->fold[2] = 0u;
  o.acc->bound = 0;
}

// Tab: `int tiles, nspec, ctiles` (all tiles, specs, compaction tiles);
// `unsigned long long* state` (the ctiles states, contiguous);
// `int locate(int g) const` (the spec of tile g); `CsrOut out(int k)
// const`; `src(int k) const` (spec k's source)
template <class Tab>
__global__ void __launch_bounds__(CT)
csr_kernel(const __grid_constant__ Tab tab, CsrHdr* hdr) {
  __shared__ int s_g, s_x, s_last;
  for (;;) {
    __syncthreads();   // the last tile's shared words are read
    if (threadIdx.x == 0) s_g = (int)atomicAdd(&hdr->taken, 1u);
    __syncthreads();
    const int g = s_g;
    if (g >= tab.tiles) break;
    const int k = tab.locate(g);
    const CsrOut o = tab.out(k);
    if (g < o.pad0)
      csr_compact_tile(tab.src(k), o, g - o.tile0, &s_x);
    else
      csr_pad_tile(o, g - o.pad0, &s_x);
  }
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(&hdr->done, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int k = threadIdx.x; k < tab.nspec; k += CT) csr_finish(tab.out(k));
  for (int i = threadIdx.x; i < tab.ctiles; i += CT) tab.state[i] = 0ull;
  if (threadIdx.x == 0) {
    hdr->taken = 0u;
    hdr->done = 0u;
  }
}

// A one-spec launch whose work fits one block (at most one compaction
// tile and one pad tile): the block runs both in turn, with the total and
// the partial sums in shared memory -- no tile counter, look-back, wait or
// finishing ticket, and the scratch untouched (it stays zeroed).
template <class Src>
__global__ void __launch_bounds__(CT)
csr_solo_kernel(const __grid_constant__ Src src, CsrOut o) {
  __shared__ CsrAcc acc;
  __shared__ int s_x;
  if (threadIdx.x == 0) {
    acc = CsrAcc{};
    s_x = 0;
  }
  __syncthreads();
  o.acc = &acc;
  if (o.ntiles == 1) csr_compact_tile<Src, true>(src, o, 0, &s_x);
  csr_pad_tile<true>(o, 0, &s_x);
  __syncthreads();
  if (threadIdx.x == 0) {
    if (o.csum != nullptr) *o.csum = acc.fold[0] ^ acc.fold[1] ^ acc.fold[2];
    if (o.bound != nullptr) *o.bound = acc.bound;
  }
}

// one spec, by value
template <class Src>
struct CsrOne {
  Src s_;
  CsrOut o_;
  int tiles, nspec, ctiles;
  unsigned long long* state;
  __device__ __forceinline__ int locate(int) const { return 0; }
  __device__ __forceinline__ CsrOut out(int) const { return o_; }
  __device__ __forceinline__ const Src& src(int) const { return s_; }
};

// the SMs of the current card (looked up once a card)
static inline int sm_count() {
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& m = sms[dev & 63];
  if (m <= 0) {
    cudaDeviceGetAttribute(&m, cudaDevAttrMultiProcessorCount, dev);
    if (m <= 0) m = 1;
  }
  return m;
}

// the launch's blocks: at most four an SM of the current card
static inline int csr_grid(int tiles) {
  const int m = sm_count();
  return tiles < 1 ? 1 : (tiles < 4 * m ? tiles : 4 * m);
}

// a spec's CsrOut over scratch laid out for one spec (tw: its source's
// words a compaction tile)
static inline CsrOut csr_out_one(int s, int w, const int* ts, int out_cap,
                                 int* indptr, int* dep_rows, int* dep_ts,
                                 int* bound, unsigned* csum, void* scratch,
                                 FoldSeeds seeds, int tw = CW) {
  CsrOut o;
  o.ts = ts;
  o.indptr = indptr;
  o.dep_rows = dep_rows;
  o.dep_ts = dep_ts;
  o.bound = bound;
  o.csum = csum;
  o.acc = (CsrAcc*)((char*)scratch + sizeof(CsrHdr));
  o.state = (unsigned long long*)((char*)scratch + sizeof(CsrHdr) +
                                  sizeof(CsrAcc));
  o.n = (long long)s * w;
  o.s = s;
  o.w = w;
  o.out_cap = out_cap;
  o.tile0 = 0;
  o.ntiles = csr_tiles_for(o.n, tw);
  o.pad0 = o.ntiles;
  o.npad = csr_pads_for(out_cap);
  o.seeds = seeds;
  return o;
}

// the compaction of one spec: ONE launch (one block, csr_solo_kernel,
// where the work fits it). scratch: a CsrHdr, one CsrAcc and a u64 state
// per compaction tile (csr_tiles_for(s * src.w, CT *
// csr_ci<Src>::value)), zeroed, and left zeroed; the bound (when `bound`
// is not null) is the sum of the source's kw popcounts. Returns
// cudaGetLastError.
template <class Src>
static inline int launch_csr(const Src& src, int s, const int* ts,
                             int out_cap, int* indptr, int* dep_rows,
                             int* dep_ts, int* bound, unsigned* csum,
                             void* scratch, cudaStream_t st,
                             FoldSeeds seeds = FoldSeeds{1u, 5u, 9u}) {
  if (s < 0 || out_cap < 0) return (int)cudaErrorInvalidValue;
  CsrOne<Src> tab;
  tab.s_ = src;
  tab.o_ = csr_out_one(s, src.w, ts, out_cap, indptr, dep_rows, dep_ts,
                       bound, csum, scratch, seeds, CT * csr_ci<Src>::value);
  tab.ctiles = tab.o_.ntiles;
  tab.tiles = tab.o_.ntiles + tab.o_.npad;
  tab.nspec = 1;
  tab.state = tab.o_.state;
  if (tab.o_.ntiles <= 1 && tab.o_.npad == 1)
    csr_solo_kernel<Src><<<1, CT, 0, st>>>(src, tab.o_);
  else
    csr_kernel<CsrOne<Src>><<<csr_grid(tab.tiles), CT, 0, st>>>(
        tab, (CsrHdr*)scratch);
  ACCORD_CHECK();
  return 0;
}

// ---------------------------------------------------------------------------
// One launch copying up to COPY_SEGS whole tensors into fresh outputs (the
// functional kernels' column copies): segment k moves bytes[k] bytes from
// src[k] to dst[k], in 16-byte vectors where both pointers are 16-byte
// aligned, the tail (or a misaligned segment) byte by byte.
#define COPY_SEGS 8

struct CopyTable {
  const unsigned char* src[COPY_SEGS];
  unsigned char* dst[COPY_SEGS];
  long long bytes[COPY_SEGS];
  int n;
};

// thread `tid` of `stride` threads copying every segment of t
__device__ __forceinline__ void multi_copy_part(const CopyTable& t,
                                                long long tid,
                                                long long stride) {
  for (int k = 0; k < t.n; ++k) {
    const unsigned char* s = t.src[k];
    unsigned char* d = t.dst[k];
    const long long b = t.bytes[k];
    long long nv = 0;
    if ((((uintptr_t)s | (uintptr_t)d) & 15u) == 0) nv = b >> 4;
    for (long long i = tid; i < nv; i += stride)
      ((uint4*)d)[i] = ((const uint4*)s)[i];
    for (long long i = (nv << 4) + tid; i < b; i += stride) d[i] = s[i];
  }
}

__global__ void multi_copy_kernel(const __grid_constant__ CopyTable t) {
  multi_copy_part(t, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                  (long long)gridDim.x * blockDim.x);
}

static inline int launch_multi_copy(const CopyTable& t, cudaStream_t st) {
  long long most = 1;
  for (int k = 0; k < t.n; ++k)
    if (t.bytes[k] / 16 + 16 > most) most = t.bytes[k] / 16 + 16;
  multi_copy_kernel<<<grid_for(most, 256), 256, 0, st>>>(t);
  ACCORD_CHECK();
  return 0;
}
