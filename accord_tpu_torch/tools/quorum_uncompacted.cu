// K16 (csrc/quorum.cu) without its compaction of the fast voters, kept to
// time the shipped kernel beside it on the same card
// (tools/quorum_conflict_variants.py binds this entry in place of the
// shipped one: the same C name and signature). Built only by that tool and
// by chip_smoke.py, never by ops/_ext.py.
//
// The same grid, clusters and distributed-shared-memory sum as the shipped
// kernel. A CTA stages EVERY lane j of its chunk as int4 {t0, t1, t2,
// fast} (no ballot, no shared counter) and each thread compares its txn
// with every staged lane, adding the lane's fast bit: the compare loop runs
// over all t / S lanes j of the slice, the padded and non-fast ones too.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define QT 256
#define QJ 2
#define QS_MAX 8
#define QS_SLICE 128

__global__ void __launch_bounds__(QT)
quorum_kernel(const int* __restrict__ txn, const int* __restrict__ ts,
              const int* __restrict__ code,
              const unsigned char* __restrict__ valid, int t, int qsize,
              unsigned char* __restrict__ fast_out,
              int* __restrict__ votes_out, unsigned char* __restrict__ met) {
  __shared__ int4 s_lane[QT * QJ];
  __shared__ int s_part[QT];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int i = (blockIdx.x / S) * blockDim.x + tid;
  int a0 = 0, a1 = 0, a2 = 0, b0 = 0, b1 = 0, b2 = 0, ci = 0;
  unsigned char vi = 0;
  if (i < t) {
    a0 = txn[3 * i];
    a1 = txn[3 * i + 1];
    a2 = txn[3 * i + 2];
    b0 = ts[3 * i];
    b1 = ts[3 * i + 1];
    b2 = ts[3 * i + 2];
    ci = code[i];
    vi = valid[i];
  }
  const bool fi = vi != 0 && (ci & 7) == 0 && b0 == a0 && b1 == a1 &&
                  b2 == a2;
  const int per = (t + S - 1) / S;
  const int j_lo = rank * per;
  const int j_hi = min(t, j_lo + per);
  const int chunk = blockDim.x * QJ;
  int v = 0;
  for (int c0 = j_lo; c0 < j_hi; c0 += chunk) {
    int x0[QJ], x1[QJ], x2[QJ], y0[QJ], y1[QJ], y2[QJ], cd[QJ];
    unsigned char ok[QJ];
#pragma unroll
    for (int k = 0; k < QJ; ++k) {
      const int j = c0 + k * blockDim.x + tid;
      x0[k] = x1[k] = x2[k] = y0[k] = y1[k] = y2[k] = cd[k] = 0;
      ok[k] = 0;
      if (j < j_hi) {
        x0[k] = txn[3 * j];
        x1[k] = txn[3 * j + 1];
        x2[k] = txn[3 * j + 2];
        y0[k] = ts[3 * j];
        y1[k] = ts[3 * j + 1];
        y2[k] = ts[3 * j + 2];
        cd[k] = code[j];
        ok[k] = valid[j];
      }
    }
    __syncthreads();  // the last chunk's compares are done
#pragma unroll
    for (int k = 0; k < QJ; ++k) {
      const bool f = ok[k] != 0 && (cd[k] & 7) == 0 && y0[k] == x0[k] &&
                     y1[k] == x1[k] && y2[k] == x2[k];
      s_lane[k * blockDim.x + tid] = make_int4(x0[k], x1[k], x2[k], f);
    }
    __syncthreads();
    const int n = min(chunk, j_hi - c0);
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int4 e = s_lane[k];
      v += e.w & (int)((e.x == a0) & (e.y == a1) & (e.z == a2));
    }
  }
  s_part[tid] = v;
  cluster.sync();
  if (i < t && tid % S == rank) {
    int part[QS_MAX];
#pragma unroll
    for (int q = 0; q < QS_MAX; ++q)
      part[q] = q < S ? cluster.map_shared_rank(s_part, q)[tid] : 0;
    int total = 0;
#pragma unroll
    for (int q = 0; q < QS_MAX; ++q) total += part[q];
    fast_out[i] = fi ? 1 : 0;
    votes_out[i] = total;
    met[i] = (fi && total >= qsize) ? 1 : 0;
  }
  cluster.sync();
}

extern "C" int quorum_count(const void* txn, const void* ts, const void* code,
                            const void* valid, int t, int qsize, void* fast,
                            void* votes, void* met, void* stream) {
  if (t <= 0) return 0;
  const int threads = ((min(t, QT) + 31) / 32) * 32;
  const int tiles = (t + threads - 1) / threads;
  const int S = max(1, min(QS_MAX, t / QS_SLICE));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * S, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = S;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, quorum_kernel, (const int*)txn, (const int*)ts,
      (const int*)code, (const unsigned char*)valid, t, qsize,
      (unsigned char*)fast, (int*)votes, (unsigned char*)met);
  if (e != cudaSuccess) return (int)e;
  ACCORD_CHECK();
  return 0;
}
