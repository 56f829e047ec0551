// K9: the exec plane's release frontier, one store or fused over a node's
// stores, and its compaction into exact released-row lists.
//
// Replaces accord_tpu/ops/kernels.py `execution_frontier` (:143, with the
// release test `_frontier_ready` :133), `fused_execution_frontier` (:174)
// and `frontier_compact` (:651, body `_frontier_compact_body` :619).
//
// Waiter row w of a plane is released iff pending[w] and no dep d has
//   adj[w, d] & ~applied[d] & (awaits_all[w] | exec_ts[d] <=lex exec_ts[w])
// over three signed int32 lanes (INT32_MIN in every lane while undecided:
// an undecided dep is <= everything and always gates; equal exec_ts gates
// too; adj[w, w] is treated like any other edge). The adjacency is packed
// int32 [cap, cap/32] (dep d in bit d & 31 of word d >> 5).
//
// What bounds it: bytes, the pending rows' adjacency read once (cap^2/8,
// 32 MB at cap 16384 when every row is pending) plus 15 bytes of lanes a
// row; the word tests are far below the card's op rate. The adjacency the
// exec plane builds is sparse (a waiter's few deps), so the rest is load
// latency: the design keeps every load of a step in flight at once.
//
// The body (ft_word) computes one output word (32 rows) in a block of 8
// warps, with no block barrier before its end:
//   * ownership first: every warp loads the word's 32 `pending` bytes (a
//     lane a row) and takes the ballot itself. A row that is not pending
//     costs nothing more.
//   * the warps take batches of pending rows in turn (as many rows as fit
//     FQ 16-byte slots a lane: 1 at cap 16,384, 16 at cap 1,024, but few
//     enough that every warp gets one); a batch issues every 16-byte load
//     of its rows' words at once, with the waiters' awaits_all and exec_ts
//     beside them;
//   * each set bit of those words names a dep whose applied byte and
//     exec_ts are gathered together: a lane holding at most two set bits
//     issues its gathers at once (the exec plane's sparse rows); where a
//     lane holds more, the batch lists its bits in shared memory (a lane's
//     offset by a warp scan) and the lanes gather FB entries a round, all
//     issued before any test. A dep that is applied never gates; else an
//     awaits_all waiter is gated, or one whose exec_ts is not before the
//     dep's. No applied lane is packed: a dep's byte is read only where an
//     edge names it.
// Entries, each ONE launch of a block an output word: `exec_frontier`
// (one plane: execution_frontier; several: fused_execution_frontier, the
// planes' words concatenated; caps may differ) and `frontier_compact`,
// which computes and compacts in the same launch: every block writes its
// word to `packed`, zeroes its slice of `rows` and takes an atomic
// ticket; the block that takes the last one compacts every word (a
// thread a run of words, offsets by a block scan): indptr[s] where plane
// s starts and indptr[S] (exact past out_cap), the released rows as
// GLOBAL bit indices (32 * word + bit) below out_cap over the zeros, and
// the checksum folding indptr (seed 13) and all out_cap rows (seed 17;
// the padding folds to 0); it zeroes the ticket again, so the next
// launch -- or a graph replay -- finds it so. Segment s is plane s: the
// block-diagonal [S, w_tot] matrix of the JAX body.
#include "common.cuh"

#define FT 256          // threads a block (8 warps): common.cuh's CT
#define FMAXP 32        // planes a launch
#define FQ 4            // adjacency slots a lane loads in one pass
#define FB 32           // listed dep entries a warp gathers in one round
#define FBLK 4          // blocks an SM (64 registers a thread)
#define FULL 0xffffffffu

static_assert(FT == CT, "the block helpers of common.cuh take CT threads");

struct FPlane {
  const unsigned* adj;
  const int* ts;
  const unsigned char* applied;
  const unsigned char* pending;
  const unsigned char* awaits;
  int cap;
  int word_off;  // first output word of this plane
  int vec;       // rows read as 16-byte vectors (cap % 128 == 0, aligned)
};

struct FPlanes {
  FPlane p[FMAXP];
  int n;
  int w_tot;     // output words in all
};

// a block's working set: each warp's released bits, dep list and waiters
struct FSmem {
  unsigned out[FT / 32];
  int dep[FT / 32][FB];
  int wts[FT / 32][32][3];
};

// the plane holding output word `word`
__device__ __forceinline__ int ft_plane_of(const FPlanes& ps, int word) {
  int p = 0;
  while (p + 1 < ps.n && word >= ps.p[p + 1].word_off) ++p;
  return p;
}

template <int V>
struct FVec;
template <>
struct FVec<4> {
  typedef uint4 T;
  static __device__ __forceinline__ T load(const unsigned* p) {
    return __ldg((const uint4*)p);
  }
  static __device__ __forceinline__ T zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ unsigned at(const T& x, int j) {
    return j == 0 ? x.x : j == 1 ? x.y : j == 2 ? x.z : x.w;
  }
  static __device__ __forceinline__ bool any(const T& x) {
    return (x.x | x.y | x.z | x.w) != 0u;
  }
};
template <>
struct FVec<1> {
  typedef unsigned T;
  static __device__ __forceinline__ T load(const unsigned* p) {
    return __ldg(p);
  }
  static __device__ __forceinline__ T zero() { return 0u; }
  static __device__ __forceinline__ unsigned at(const T& x, int) { return x; }
  static __device__ __forceinline__ bool any(const T& x) { return x != 0u; }
};

// whether dep d (applied byte ap, exec_ts d0-d2) gates waiter k (exec_ts
// in wts[k], awaits_all in bit k of awm): not applied, and k awaits all or
// exec_ts[d] <=lex exec_ts[k] (== !(exec_ts[k] <lex exec_ts[d]))
__device__ __forceinline__ bool ft_gates(unsigned char ap, int d0, int d1,
                                         int d2, int k, unsigned awm,
                                         const int (*wts)[3]) {
  return !ap && (((awm >> k) & 1u) ||
                 !lex_before(wts[k][0], wts[k][1], wts[k][2], d0, d1, d2));
}

// One warp: the gated mask (bit k) of nr <= 32 pending rows of plane P,
// lane k holding row k (plane-local, `row`), cpr chunks of V words a row.
// Every pass issues its FQ slots' loads (and, first, the waiters' lanes)
// before any test; a lane's first two set bits are gathered at once, and
// a pass where some lane holds more lists every bit in shared memory and
// gathers FB entries a round.
template <int V>
__device__ __forceinline__ unsigned ft_batch(const FPlane& P, int row,
                                             int nr, int cpr, FSmem& sm) {
  typedef FVec<V> F;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = P.cap >> 5;
  const int sh = (cpr & (cpr - 1)) == 0 ? __ffs(cpr) - 1 : -1;
  int* dep = sm.dep[warp];
  int(*wts)[3] = sm.wts[warp];
  bool aw = false;
  int t0 = 0, t1 = 0, t2 = 0;
  if (lane < nr) {
    aw = __ldg(P.awaits + row) != 0;
    t0 = __ldg(P.ts + 3 * row);
    t1 = __ldg(P.ts + 3 * row + 1);
    t2 = __ldg(P.ts + 3 * row + 2);
  }
  unsigned gated = 0u;
  unsigned awm = 0u;
  const int tot = nr * cpr;
  for (int base = 0; base < tot; base += 32 * FQ) {
    typename F::T x[FQ];
    const int nq = min(FQ, (tot - base + 31) >> 5);   // slots this pass
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      x[q] = F::zero();
      if (q >= nq) continue;   // uniform across the warp
      const int s = base + 32 * q + lane;
      const int k = sh >= 0 ? s >> sh : s / cpr;
      const int w = __shfl_sync(FULL, row, k & 31);
      if (s < tot)
        x[q] = F::load(P.adj + (size_t)w * W + (size_t)(s - k * cpr) * V);
    }
    if (base == 0) {
      awm = __ballot_sync(FULL, aw);
      if (lane < nr) {
        wts[lane][0] = t0;
        wts[lane][1] = t1;
        wts[lane][2] = t2;
      }
      __syncwarp();
    }
    // this lane's set bits: the first two kept, the count
    int cnt = 0, da = -1, ka = 0, db = -1, kb = 0;
#pragma unroll
    for (int q = 0; q < FQ; ++q) {
      if (q >= nq || !F::any(x[q])) continue;
      const int s = base + 32 * q + lane;
      const int k = sh >= 0 ? s >> sh : s / cpr;
      const int c = s - k * cpr;
#pragma unroll
      for (int j = 0; j < V; ++j)
        for (unsigned u = F::at(x[q], j); u; u &= u - 1u, ++cnt) {
          const int d = 32 * (c * V + j) + __ffs(u) - 1;
          if (cnt == 0) {
            da = d;
            ka = k;
          } else if (cnt == 1) {
            db = d;
            kb = k;
          }
        }
    }
    if (__all_sync(FULL, cnt <= 2)) {
      unsigned char apa = 1, apb = 1;
      int a0 = 0, a1 = 0, a2 = 0, b0 = 0, b1 = 0, b2 = 0;
      if (da >= 0) {
        apa = __ldg(P.applied + da);
        a0 = __ldg(P.ts + 3 * da);
        a1 = __ldg(P.ts + 3 * da + 1);
        a2 = __ldg(P.ts + 3 * da + 2);
      }
      if (db >= 0) {
        apb = __ldg(P.applied + db);
        b0 = __ldg(P.ts + 3 * db);
        b1 = __ldg(P.ts + 3 * db + 1);
        b2 = __ldg(P.ts + 3 * db + 2);
      }
      if (ft_gates(apa, a0, a1, a2, ka, awm, wts)) gated |= 1u << ka;
      if (ft_gates(apb, b0, b1, b2, kb, awm, wts)) gated |= 1u << kb;
      continue;
    }
    // some lane holds more: list every bit, FB a round
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    for (int r0 = 0; r0 < total; r0 += FB) {
      __syncwarp();   // the last round's entries read
      int idx = incl - cnt;
#pragma unroll
      for (int q = 0; q < FQ; ++q) {
        if (!F::any(x[q])) continue;
        const int s = base + 32 * q + lane;
        const int k = sh >= 0 ? s >> sh : s / cpr;
        const int c = s - k * cpr;
#pragma unroll
        for (int j = 0; j < V; ++j)
          for (unsigned u = F::at(x[q], j); u; u &= u - 1u, ++idx)
            if (idx >= r0 && idx < r0 + FB)
              dep[idx - r0] = ((32 * (c * V + j) + __ffs(u) - 1) << 5) | k;
      }
      __syncwarp();
      const int m = min(FB, total - r0);
      unsigned char ap[FB / 32];
      int d0[FB / 32], d1[FB / 32], d2[FB / 32], kk[FB / 32];
#pragma unroll
      for (int j = 0; j < FB / 32; ++j) {
        const int e = lane + 32 * j;
        ap[j] = 1;
        kk[j] = 0;
        if (e < m) {
          const int v = dep[e];
          const int d = v >> 5;
          kk[j] = v & 31;
          ap[j] = __ldg(P.applied + d);
          d0[j] = __ldg(P.ts + 3 * d);
          d1[j] = __ldg(P.ts + 3 * d + 1);
          d2[j] = __ldg(P.ts + 3 * d + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < FB / 32; ++j)
        if (ft_gates(ap[j], d0[j], d1[j], d2[j], kk[j], awm, wts))
          gated |= 1u << kk[j];
    }
  }
  return __reduce_or_sync(FULL, gated);
}

// the position of the n-th (from 0) set bit of m
__device__ __forceinline__ int ft_nth_bit(unsigned m, int n) {
  for (; n > 0; --n) m &= m - 1u;
  return __ffs(m) - 1;
}

// The released bits of output word `word`, in every thread on return.
// Every warp loads the word's pending bytes (a lane a row) and takes the
// ballot; the word's pending rows go to the warps in batches of `per`
// (as many as FQ slots a lane hold, few enough that every warp gets
// one), warp w taking batches w, w + 8, ...; the warps' released bits
// meet in shared memory at the one block barrier.
__device__ __forceinline__ unsigned ft_word(const FPlanes& ps, int word,
                                            FSmem& sm) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const FPlane& P = ps.p[ft_plane_of(ps, word)];
  const int wl = word - P.word_off;
  const unsigned pm = __ballot_sync(FULL, __ldg(P.pending + 32 * wl + lane));
  unsigned mine = 0u;
  const int np = __popc(pm);
  const int cpr = (P.cap >> 5) / (P.vec ? 4 : 1);
  const int per = max(1, min(max(1, min(32, 32 * FQ / cpr)),
                             (np + FT / 32 - 1) / (FT / 32)));
  for (int b = warp; b * per < np; b += FT / 32) {
    const int nr = min(per, np - b * per);
    const int row = lane < nr ? 32 * wl + ft_nth_bit(pm, b * per + lane) : 0;
    const unsigned gated = P.vec ? ft_batch<4>(P, row, nr, cpr, sm)
                                 : ft_batch<1>(P, row, nr, cpr, sm);
    if (lane < nr && !((gated >> lane) & 1u)) mine |= 1u << (row & 31);
  }
  mine = __reduce_or_sync(FULL, mine);
  if (lane == 0) sm.out[warp] = mine;
  __syncthreads();
  unsigned v = 0u;
#pragma unroll
  for (int w = 0; w < FT / 32; ++w) v |= sm.out[w];
  return v;
}

// rows[lo, hi) = 0 by the block: 16-byte stores from the first 16-byte
// boundary, single ones at either end
__device__ __forceinline__ void ft_zero(int* rows, int lo, int hi) {
  int va = lo + (int)(((16u - ((unsigned)(uintptr_t)(rows + lo) & 15u)) &
                       15u) >> 2);
  if (va > hi) va = hi;
  const int nv = (hi - va) >> 2;
  for (int e = lo + threadIdx.x; e < va; e += FT) rows[e] = 0;
  for (int v = threadIdx.x; v < nv; v += FT)
    *(int4*)(rows + va + 4 * v) = make_int4(0, 0, 0, 0);
  for (int e = va + 4 * nv + threadIdx.x; e < hi; e += FT) rows[e] = 0;
}

// frontier_compact's compaction, by the last block (every thread): the
// packed words (written by every block) into indptr, the released rows
// below out_cap as GLOBAL bit indices (every block zeroed its slice of
// `rows` before its ticket: the padding is done) and the checksum. A
// thread takes a run of words (the first FR kept in registers from its
// count to its writes), a block scan gives each run's offset, and the
// run where a plane starts writes that plane's indptr.
__device__ __forceinline__ void ft_compact(const FPlanes& ps,
                                           const unsigned* packed,
                                           int out_cap, int* indptr,
                                           int* rows, unsigned* csum) {
  constexpr int FR = 4;
  const int t = threadIdx.x;
  const int per = (ps.w_tot + FT - 1) / FT;
  const int w0 = min(ps.w_tot, t * per), w1 = min(ps.w_tot, w0 + per);
  unsigned wv[FR];
  int c = 0;
#pragma unroll
  for (int i = 0; i < FR; ++i) {
    wv[i] = w0 + i < w1 ? __ldcg(packed + w0 + i) : 0u;
    c += __popc(wv[i]);
  }
  for (int j = w0 + FR; j < w1; ++j) c += __popc(__ldcg(packed + j));
  auto word = [&](int j) {   // word j of this run: kept, else from L2
    unsigned m = 0u;
    bool kept = false;
#pragma unroll
    for (int i = 0; i < FR; ++i)
      if (j == w0 + i) {
        m = wv[i];
        kept = true;
      }
    return kept ? m : __ldcg(packed + j);
  };
  int total;
  const int ex = block_excl_scan(c, &total);
  unsigned f13 = 0u, f17 = 0u, f0 = 0u;
  int q = ex;
  for (int j = w0; j < w1 && q < out_cap; ++j)
    for (unsigned m = word(j); m && q < out_cap; m &= m - 1u, ++q) {
      const int row = 32 * j + __ffs(m) - 1;
      rows[q] = row;
      f17 += fold_term(row, (unsigned)q, 17u);
    }
  for (int k = 0; k < ps.n; ++k) {   // a plane starting in this run
    const int wo = ps.p[k].word_off;
    if (wo < w0 || wo >= w1) continue;
    int x = ex;
    for (int j = w0; j < wo; ++j) x += __popc(word(j));
    indptr[k] = x;
    f13 += fold_term(x, (unsigned)k, 13u);
  }
  if (t == 0) {
    indptr[ps.n] = total;
    f13 += fold_term(total, (unsigned)ps.n, 13u);
  }
  block_sum3(f13, f17, f0);
  if (t == 0) *csum = f13 ^ f17;
}

// a block an output word, written to `out`; compacting, every block then
// zeroes its slice of `rows`, takes a ticket, and the last one compacts
// (ft_compact) and zeroes the ticket again
__global__ void __launch_bounds__(FT, FBLK)
frontier_kernel(const __grid_constant__ FPlanes ps, unsigned* out,
                int compact, int out_cap, int* indptr, int* rows,
                unsigned* csum, unsigned* ticket) {
  __shared__ FSmem sm;
  __shared__ int s_last;
  const unsigned v = ft_word(ps, blockIdx.x, sm);
  if (threadIdx.x == 0) out[blockIdx.x] = v;
  if (!compact) return;
  const int slice = (out_cap + gridDim.x - 1) / gridDim.x;
  ft_zero(rows, min(out_cap, (int)blockIdx.x * slice),
          min(out_cap, (int)(blockIdx.x + 1) * slice));
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(ticket, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *ticket = 0u;
  ft_compact(ps, out, out_cap, indptr, rows, csum);
}

// the planes' table from the caller's arrays (n <= FMAXP)
static int make_planes(FPlanes* ps, int n, void* const* adj,
                       void* const* ts, void* const* applied,
                       void* const* pending, void* const* awaits,
                       const int* caps) {
  if (n < 1 || n > FMAXP) return (int)cudaErrorInvalidValue;
  int off = 0;
  for (int k = 0; k < n; ++k) {
    if (caps[k] <= 0 || caps[k] % 32) return (int)cudaErrorInvalidValue;
    const int vec = caps[k] % 128 == 0 && (((uintptr_t)adj[k]) & 15u) == 0;
    ps->p[k] = FPlane{(const unsigned*)adj[k], (const int*)ts[k],
                      (const unsigned char*)applied[k],
                      (const unsigned char*)pending[k],
                      (const unsigned char*)awaits[k], caps[k], off, vec};
    off += caps[k] / 32;
  }
  ps->n = n;
  ps->w_tot = off;
  return 0;
}

// the fused frontier (n == 1: one store's execution_frontier) into
// out[w_tot]; the per-plane arrays hold device pointers and caps. ONE
// launch.
extern "C" int exec_frontier(int n, void* const* adj, void* const* ts,
                             void* const* applied, void* const* pending,
                             void* const* awaits, const int* caps, void* out,
                             void* stream) {
  FPlanes ps;
  int rc = make_planes(&ps, n, adj, ts, applied, pending, awaits, caps);
  if (rc != 0) return rc;
  frontier_kernel<<<ps.w_tot, FT, 0, (cudaStream_t)stream>>>(
      ps, (unsigned*)out, 0, 0, nullptr, nullptr, nullptr, nullptr);
  ACCORD_CHECK();
  return 0;
}

// frontier_compact: packed[w_tot] (retained), indptr[n+1], rows[out_cap],
// csum; scratch: zeroed bytes (kernels.frontier_scratch_bytes) whose first
// word is the exit ticket, left zeroed. ONE launch.
extern "C" int frontier_compact(int n, void* const* adj, void* const* ts,
                                void* const* applied, void* const* pending,
                                void* const* awaits, const int* caps,
                                int out_cap, void* packed, void* indptr,
                                void* rows, void* csum, void* scratch,
                                void* stream) {
  if (out_cap < 0) return (int)cudaErrorInvalidValue;
  FPlanes ps;
  int rc = make_planes(&ps, n, adj, ts, applied, pending, awaits, caps);
  if (rc != 0) return rc;
  frontier_kernel<<<ps.w_tot, FT, 0, (cudaStream_t)stream>>>(
      ps, (unsigned*)packed, 1, out_cap, (int*)indptr, (int*)rows,
      (unsigned*)csum, (unsigned*)scratch);
  ACCORD_CHECK();
  return 0;
}
