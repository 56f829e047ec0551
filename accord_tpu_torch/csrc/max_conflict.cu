// K7: the inline max-conflict query.
//
// Replaces accord_tpu/ops/kernels.py `max_conflict` (:65). For each
// subject (packed bucket words [B, K/32], the key arena's bucket layout):
// the lexicographic 3-lane max of exec_ts over the arena rows that are
// valid and whose packed bucket words meet the subject's, and the winning
// row -- the lowest row among exact ties (jnp.argmax), -1 when no row
// overlaps, with the lanes then INT32_MIN. A row whose lane 0 is INT32_MIN
// still wins over "no row": the candidate carries its row, and a row of -1
// marks "none", so no timestamp value doubles as the sentinel.
//
// ONE launch, one CTA a subject (up to MC_THREADS threads). Ownership
// first: warp 0 lists the subject's NONZERO words (index, word) in shared
// memory before any row is touched, and an all-zero subject (the pads of
// a bucketed batch) writes "none" and leaves with no row load. Then each
// thread takes MC_RB rows a batch (r = base + k * blockDim + tid) and
// issues the loads of the batch -- `valid`, then one listed word a pass,
// that word of every row of the batch -- before it tests any of them: no
// early-exit chain of dependent loads. exec_ts is read only for the rows that meet, every such load of
// the batch before the first compare. A thread keeps its best row by
// `beats`; a warp, then one warp over the warps' winners, reduce lane by
// lane with warp reductions (max lane 0, lane 1 and lane 2 among the ties,
// the lowest row).
//
// What bounds it: bytes -- the subject's nonzero words of every row, the
// valid lane, exec_ts of the meeting rows; a subject with few buckets
// reads a sector of a row, not the row.
#include <climits>

#include "common.cuh"

#define MC_THREADS 1024  // threads of a subject's CTA, at most
#define MC_RB 4          // rows a thread loads a batch

struct Cand {
  int l0, l1, l2, row;
};

// a beats b: a real row over none; a greater triple; the lower row on ties
__device__ __forceinline__ bool beats(const Cand& a, const Cand& b) {
  if (a.row < 0) return false;
  if (b.row < 0) return true;
  if (a.l0 != b.l0) return a.l0 > b.l0;
  if (a.l1 != b.l1) return a.l1 > b.l1;
  if (a.l2 != b.l2) return a.l2 > b.l2;
  return a.row < b.row;
}

// the warp's best candidate, the same in every lane: the max lane 0 over
// the lanes holding a row, then lane 1 and lane 2 among the ties, then the
// lowest tied row -- four warp reductions (REDUX), no shuffle tree
__device__ __forceinline__ Cand warp_best(const Cand& c) {
  const bool has = c.row >= 0;
  const int m0 = __reduce_max_sync(0xffffffffu, has ? c.l0 : INT_MIN);
  const bool t0 = has && c.l0 == m0;
  const int m1 = __reduce_max_sync(0xffffffffu, t0 ? c.l1 : INT_MIN);
  const bool t1 = t0 && c.l1 == m1;
  const int m2 = __reduce_max_sync(0xffffffffu, t1 ? c.l2 : INT_MIN);
  const bool t2 = t1 && c.l2 == m2;
  const int row = __reduce_min_sync(0xffffffffu, t2 ? c.row : INT_MAX);
  return Cand{m0, m1, m2, row == INT_MAX ? -1 : row};
}

__global__ void __launch_bounds__(MC_THREADS)
max_conflict_kernel(const unsigned* __restrict__ subj, int nw,
                    const unsigned* __restrict__ act_bm,
                    const int* __restrict__ exec_ts,
                    const unsigned char* __restrict__ valid, int cap,
                    int* __restrict__ lanes, int* __restrict__ rows) {
  __shared__ unsigned s_word[32];
  __shared__ int s_idx[32];
  __shared__ int s_nnz;
  __shared__ Cand s_best[MC_THREADS / 32];
  const int sb = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (warp == 0) {
    const unsigned w = lane < nw ? subj[(long long)sb * nw + lane] : 0u;
    const unsigned m = __ballot_sync(0xffffffffu, w != 0u);
    if (w != 0u) {
      const int p = __popc(m & ((1u << lane) - 1u));
      s_word[p] = w;
      s_idx[p] = lane;
    }
    if (lane == 0) s_nnz = __popc(m);
  }
  __syncthreads();
  const int nnz = s_nnz;
  if (nnz == 0) {  // no bucket: no row can meet it
    if (tid == 0) {
      lanes[sb * 3] = INT_MIN;
      lanes[sb * 3 + 1] = INT_MIN;
      lanes[sb * 3 + 2] = INT_MIN;
      rows[sb] = -1;
    }
    return;
  }
  Cand best{INT_MIN, INT_MIN, INT_MIN, -1};
  const int step = blockDim.x * MC_RB;
  for (int r0 = 0; r0 < cap; r0 += step) {
    int r[MC_RB];
    unsigned acc[MC_RB];
    unsigned char ok[MC_RB];
#pragma unroll
    for (int k = 0; k < MC_RB; ++k) {
      r[k] = r0 + k * blockDim.x + tid;
      acc[k] = 0u;
      ok[k] = r[k] < cap ? valid[r[k]] : 0;
    }
    // a listed word a pass, that word of every row of the batch in flight
    for (int u = 0; u < nnz; ++u) {
      const int xi = s_idx[u];
      const unsigned m = s_word[u];
      unsigned x[MC_RB];
#pragma unroll
      for (int k = 0; k < MC_RB; ++k)
        x[k] = r[k] < cap ? act_bm[(long long)r[k] * nw + xi] : 0u;
#pragma unroll
      for (int k = 0; k < MC_RB; ++k) acc[k] |= x[k] & m;
    }
    // the meeting rows' exec_ts, all loads before the first compare
    int e0[MC_RB], e1[MC_RB], e2[MC_RB];
#pragma unroll
    for (int k = 0; k < MC_RB; ++k) {
      const bool hit = ok[k] && acc[k];
      e0[k] = hit ? exec_ts[3 * r[k]] : INT_MIN;
      e1[k] = hit ? exec_ts[3 * r[k] + 1] : INT_MIN;
      e2[k] = hit ? exec_ts[3 * r[k] + 2] : INT_MIN;
    }
#pragma unroll
    for (int k = 0; k < MC_RB; ++k) {
      const Cand c{e0[k], e1[k], e2[k], (ok[k] && acc[k]) ? r[k] : -1};
      if (beats(c, best)) best = c;
    }
  }
  best = warp_best(best);
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < (int)(blockDim.x >> 5)
               ? s_best[lane]
               : Cand{INT_MIN, INT_MIN, INT_MIN, -1};
    best = warp_best(best);
    if (lane == 0) {  // no meeting row: INT32_MIN lanes and row -1
      lanes[sb * 3] = best.l0;
      lanes[sb * 3 + 1] = best.l1;
      lanes[sb * 3 + 2] = best.l2;
      rows[sb] = best.row;
    }
  }
}

extern "C" int max_conflict(const void* subj, int b, int nw,
                            const void* act_bm, const void* exec_ts,
                            const void* valid, int cap, void* lanes,
                            void* rows, void* stream) {
  if (nw > 32 || nw <= 0) return (int)cudaErrorInvalidValue;
  if (b == 0) return 0;
  // a thread MC_RB rows a batch, in whole warps, at most MC_THREADS
  const long long want = ((long long)cap + MC_RB - 1) / MC_RB;
  const int threads =
      (int)(want >= MC_THREADS ? MC_THREADS : ((want + 31) / 32) * 32);
  max_conflict_kernel<<<b, threads < 32 ? 32 : threads, 0,
                        (cudaStream_t)stream>>>(
      (const unsigned*)subj, nw, (const unsigned*)act_bm,
      (const int*)exec_ts, (const unsigned char*)valid, cap, (int*)lanes,
      (int*)rows);
  ACCORD_CHECK();
  return 0;
}
