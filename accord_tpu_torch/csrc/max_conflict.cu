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
// The JAX kernel narrows ties lane by lane over a [B, cap] matrix. Here one
// block per subject keeps the subject's words in shared memory; each thread
// walks rows r = tid, tid + blockDim, ... (ascending, so its first winner is
// its lowest), and a warp then block reduction over (l0, l1, l2, -row)
// picks the winner. What bounds it: operations -- cap x K/32 word ANDs per
// subject (the exec lanes are read only for overlapping rows).
#include <climits>

#include "common.cuh"

#define MC_THREADS 256

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

__device__ __forceinline__ Cand shfl_cand(const Cand& c, int d) {
  Cand o;
  o.l0 = __shfl_down_sync(0xffffffffu, c.l0, d);
  o.l1 = __shfl_down_sync(0xffffffffu, c.l1, d);
  o.l2 = __shfl_down_sync(0xffffffffu, c.l2, d);
  o.row = __shfl_down_sync(0xffffffffu, c.row, d);
  return o;
}

__global__ void __launch_bounds__(MC_THREADS)
max_conflict_kernel(const unsigned* __restrict__ subj, int nw,
                    const unsigned* __restrict__ act_bm,
                    const int* __restrict__ exec_ts,
                    const unsigned char* __restrict__ valid, int cap,
                    int* __restrict__ lanes, int* __restrict__ rows) {
  __shared__ unsigned s_subj[32];
  __shared__ Cand s_best[MC_THREADS / 32];
  const int sb = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid < nw) s_subj[tid] = subj[(long long)sb * nw + tid];
  __syncthreads();
  Cand best{INT_MIN, INT_MIN, INT_MIN, -1};
  for (int r = tid; r < cap; r += blockDim.x) {
    if (!valid[r]) continue;
    const unsigned* rw = act_bm + (long long)r * nw;
    unsigned acc = 0u;
    for (int j = 0; j < nw && !acc; ++j) acc = rw[j] & s_subj[j];
    if (!acc) continue;
    Cand c{exec_ts[r * 3], exec_ts[r * 3 + 1], exec_ts[r * 3 + 2], r};
    if (beats(c, best)) best = c;
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    Cand o = shfl_cand(best, d);
    if (beats(o, best)) best = o;
  }
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) s_best[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < (int)(blockDim.x >> 5) ? s_best[lane]
                                         : Cand{INT_MIN, INT_MIN, INT_MIN, -1};
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      Cand o = shfl_cand(best, d);
      if (beats(o, best)) best = o;
    }
    if (lane == 0) {
      const bool any = best.row >= 0;
      lanes[sb * 3] = any ? best.l0 : INT_MIN;
      lanes[sb * 3 + 1] = any ? best.l1 : INT_MIN;
      lanes[sb * 3 + 2] = any ? best.l2 : INT_MIN;
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
  cudaStream_t st = (cudaStream_t)stream;
  max_conflict_kernel<<<b, MC_THREADS, 0, st>>>(
      (const unsigned*)subj, nw, (const unsigned*)act_bm,
      (const int*)exec_ts, (const unsigned char*)valid, cap, (int*)lanes,
      (int*)rows);
  ACCORD_CHECK();
  return 0;
}
