// K16: the protocol megakernel's fast-path electorate count.
//
// Replaces the quorum stage of accord_tpu/ops/kernels.py `protocol_tick`
// (:1410-1418). Over the tick's PreAccept transition lanes (txn id, the
// echoed executeAt ts, the outcome code, valid; padded lanes have txn 0,
// ts INT32_MIN, code 0, valid 0):
//   fast[i]  = valid[i] & (code[i] & 7) == SUCCESS (0) & ts[i] == txn[i]
//   votes[i] = sum_j (txn[i] == txn[j]) & fast[j]   (for EVERY lane i)
//   met[i]   = fast[i] & votes[i] >= qsize
//
// ONE launch over a grid that fills the card at the 4,096-lane tier: a
// cluster of S CTAs a tile of up to QT lanes i (one a thread, its txn in
// registers), each CTA one of S slices of the lanes j. A CTA stages its
// slice QJ lanes a thread at a time (every load issued before any use),
// keeps only the FAST lanes -- compacted into shared memory as int4 {t0,
// t1, t2, 0} by a warp-aggregated shared counter, each fast bit computed
// once by the thread that loads it -- and each thread then compares its
// txn with every staged fast lane, one 16-byte broadcast load a lane. The
// S partial counts meet through distributed shared memory: after a cluster
// barrier, rank r sums lane tid's partials of every rank for the tids with
// tid % S == r and writes fast, votes and met; a second barrier keeps
// every CTA's partials alive until its peers have read them. No global
// scratch, no atomics outside shared memory, no memset.
//
// S = t / QS_SLICE clamped to [1, QS_MAX]: 1 at 64 lanes (one CTA), 2 at
// 256, 8 from 1,024 (16 tiles x 8 = 128 CTAs at 4,096); above that each
// CTA loops over more chunks of its slice.
//
// What bounds it: operations -- t x (fast lanes) three-lane compares
// (7.0M at the 10k tick's 4,096 lanes, 42% fast). On an H100 at 4,096
// lanes the compare loop issues ~2 us a CTA, the staging loads and the two
// cluster barriers ~1.5 us more, and the 16 clusters of 8 land on 120 SMs,
// so 8 SMs run two CTAs (phase stamps; clusters of 6 or 7, two lanes i a
// thread, or two thread groups splitting a CTA's fast lanes, measured no
// faster).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define QT 256        // lanes i a CTA (a thread each), at most
#define QJ 2          // lanes j a thread stages a chunk
#define QS_MAX 8      // CTAs a cluster (slices of the lanes j), at most
#define QS_SLICE 128  // lanes j a slice, at least (t / QS_SLICE caps S)

__global__ void __launch_bounds__(QT)
quorum_kernel(const int* __restrict__ txn, const int* __restrict__ ts,
              const int* __restrict__ code,
              const unsigned char* __restrict__ valid, int t, int qsize,
              unsigned char* __restrict__ fast_out,
              int* __restrict__ votes_out, unsigned char* __restrict__ met) {
  __shared__ int4 s_fast[QT * QJ];
  __shared__ int s_part[QT];
  __shared__ int s_n;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int i = (blockIdx.x / S) * blockDim.x + tid;
  // lane i's txn and fast bit: every load issued before any use
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
    if (tid == 0) s_n = 0;
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
    __syncthreads();  // s_n is 0 (and the last chunk's compares are done)
#pragma unroll
    for (int k = 0; k < QJ; ++k) {
      const bool f = ok[k] != 0 && (cd[k] & 7) == 0 && y0[k] == x0[k] &&
                     y1[k] == x1[k] && y2[k] == x2[k];
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (m) {
        const int leader = __ffs(m) - 1;
        int at = 0;
        if (lane == leader) at = atomicAdd(&s_n, __popc(m));
        at = __shfl_sync(0xffffffffu, at, leader);
        if (f)
          s_fast[at + __popc(m & ((1u << lane) - 1u))] =
              make_int4(x0[k], x1[k], x2[k], 0);
      }
    }
    __syncthreads();
    const int n = s_n;
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const int4 e = s_fast[k];
      v += (int)((e.x == a0) & (e.y == a1) & (e.z == a2));
    }
    __syncthreads();  // every compare read s_fast before the next chunk
  }
  s_part[tid] = v;
  cluster.sync();
  if (i < t && tid % S == rank) {
    int part[QS_MAX];  // every peer's partial in flight before the sum
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
  cluster.sync();  // no CTA leaves while a peer still reads its partials
}

// threads a CTA, the cluster size S, and the tiles of lanes i at t lanes
static void quorum_geom(int t, int* threads, int* S, int* tiles) {
  const int th = ((min(t, QT) + 31) / 32) * 32;
  *threads = th;
  *tiles = (t + th - 1) / th;
  *S = max(1, min(QS_MAX, t / QS_SLICE));
}

static cudaLaunchConfig_t quorum_config(int t, cudaStream_t st,
                                        cudaLaunchAttribute* attr) {
  int threads, S, tiles;
  quorum_geom(t, &threads, &S, &tiles);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles * S, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = S;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" int quorum_count(const void* txn, const void* ts, const void* code,
                            const void* valid, int t, int qsize, void* fast,
                            void* votes, void* met, void* stream) {
  if (t <= 0) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = quorum_config(t, (cudaStream_t)stream,
                                               &attr);
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, quorum_kernel, (const int*)txn, (const int*)ts,
      (const int*)code, (const unsigned char*)valid, t, qsize,
      (unsigned char*)fast, (int*)votes, (unsigned char*)met);
  if (e != cudaSuccess) return (int)e;
  ACCORD_CHECK();
  return 0;
}

// K16's launch at t lanes: out[0..3] = threads a CTA (a lane i each), the
// cluster size, the clusters of the grid, and the clusters the card holds
// at once (cudaOccupancyMaxActiveClusters; 0 would mean the cluster cannot
// be placed at all)
extern "C" int quorum_geometry(int t, int* out) {
  int threads, S, tiles;
  quorum_geom(max(t, 1), &threads, &S, &tiles);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = quorum_config(max(t, 1), 0, &attr);
  int active = 0;
  const cudaError_t e =
      cudaOccupancyMaxActiveClusters(&active, quorum_kernel, &cfg);
  if (e != cudaSuccess) return (int)e;
  out[0] = threads;
  out[1] = S;
  out[2] = tiles;
  out[3] = active;
  return 0;
}
