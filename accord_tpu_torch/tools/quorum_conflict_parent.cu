// The parents of K16 (csrc/quorum.cu) and K7 (csrc/max_conflict.cu), kept
// to time the shipped kernels beside them on the same card
// (tools/quorum_conflict_variants.py binds these entries in place of the
// shipped ones: the same C names and signatures). Built only by that tool
// and by chip_smoke.py, never by ops/_ext.py.
//
// K16's parent: one thread per lane i, 16 CTAs at 4,096 lanes; every lane j
// streams through shared memory in tiles of QT (the non-fast ones too),
// each CTA recomputing every tile's fast bits.
// K7's parent: one CTA of 256 threads per subject (all-zero subjects too);
// a thread walks rows tid, tid + 256, ..., ANDing a row's words one after
// another until the first that meets (a chain of dependent loads).
#include <climits>

#include "common.cuh"

#define QT 256

__device__ __forceinline__ bool lane_fast(const int* txn, const int* ts,
                                          const int* code,
                                          const unsigned char* valid, int i) {
  return valid[i] != 0 && (code[i] & 7) == 0 && ts[3 * i] == txn[3 * i] &&
         ts[3 * i + 1] == txn[3 * i + 1] && ts[3 * i + 2] == txn[3 * i + 2];
}

__global__ void __launch_bounds__(QT)
quorum_kernel(const int* __restrict__ txn, const int* __restrict__ ts,
              const int* __restrict__ code,
              const unsigned char* __restrict__ valid, int t, int qsize,
              unsigned char* __restrict__ fast_out,
              int* __restrict__ votes_out, unsigned char* __restrict__ met) {
  __shared__ int s_txn[QT * 3];
  __shared__ int s_fast[QT];
  const int i = blockIdx.x * QT + threadIdx.x;
  int a0 = 0, a1 = 0, a2 = 0;
  bool fi = false;
  if (i < t) {
    a0 = txn[3 * i];
    a1 = txn[3 * i + 1];
    a2 = txn[3 * i + 2];
    fi = lane_fast(txn, ts, code, valid, i);
  }
  int v = 0;
  for (int j0 = 0; j0 < t; j0 += QT) {
    const int j = j0 + threadIdx.x;
    if (j < t) {
      s_txn[3 * threadIdx.x] = txn[3 * j];
      s_txn[3 * threadIdx.x + 1] = txn[3 * j + 1];
      s_txn[3 * threadIdx.x + 2] = txn[3 * j + 2];
      s_fast[threadIdx.x] = lane_fast(txn, ts, code, valid, j) ? 1 : 0;
    }
    __syncthreads();
    const int n = min(QT, t - j0);
    if (i < t)
      for (int k = 0; k < n; ++k)
        v += (s_fast[k] && s_txn[3 * k] == a0 && s_txn[3 * k + 1] == a1 &&
              s_txn[3 * k + 2] == a2) ? 1 : 0;
    __syncthreads();
  }
  if (i < t) {
    fast_out[i] = fi ? 1 : 0;
    votes_out[i] = v;
    met[i] = (fi && v >= qsize) ? 1 : 0;
  }
}

extern "C" int quorum_count(const void* txn, const void* ts, const void* code,
                            const void* valid, int t, int qsize, void* fast,
                            void* votes, void* met, void* stream) {
  if (t <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  quorum_kernel<<<(t + QT - 1) / QT, QT, 0, st>>>(
      (const int*)txn, (const int*)ts, (const int*)code,
      (const unsigned char*)valid, t, qsize, (unsigned char*)fast,
      (int*)votes, (unsigned char*)met);
  ACCORD_CHECK();
  return 0;
}

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
