// K16: the protocol megakernel's fast-path electorate count.
//
// Replaces the quorum stage of accord_tpu/ops/kernels.py `protocol_tick`
// (:1410-1418). Over the tick's PreAccept transition lanes (txn id, the
// echoed executeAt ts, the outcome code, valid; padded lanes have txn 0,
// ts INT32_MIN, code 0, valid 0):
//   fast[i]  = valid[i] & (code[i] & 7) == SUCCESS (0) & ts[i] == txn[i]
//   votes[i] = sum_j (txn[i] == txn[j]) & fast[j]
//   met[i]   = fast[i] & votes[i] >= qsize
// One thread per lane; the lanes j stream through shared memory in tiles
// of QT, each tile's fast bits computed once by the thread that loads it.
//
// What bounds it: operations -- t^2 three-lane compares (16.8M at the
// 4,096-lane tier), all from shared memory.
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
