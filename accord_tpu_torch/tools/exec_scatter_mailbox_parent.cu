// The parents of K8 (csrc/exec_scatter.cu: exec_scatter) and K23
// (csrc/mailbox_shard.cu: mailbox_shard_route, mailbox_shard_land), kept
// to time the shipped kernels beside them on the same card
// (tools/exec_scatter_mailbox_variants.py binds these entries in place of
// the shipped ones: the same C names and signatures; the kernels and
// helpers behind them renamed). Built only by that tool and by
// chip_smoke.py, never by ops/_ext.py.
//
// K8's parent: a launch of common.cuh's multi_copy over all five lanes,
// then a second kernel, a thread a (dirty row, column), writing the dirty
// rows over the copy: two stream operations a call.
//
// K23's parent: a scatter kernel of a block a position, then in stream
// order a gather-back kernel, a block a position, re-reading from the
// arena every row the first kernel wrote: two launches a call (the land
// entry, on a source card, one).
#include "common.cuh"

// ---------------------------------------------------------------- K8
// one thread per (dirty row i, column c): c < words is an adjacency word,
// then the three exec_ts lanes, then applied, pending, awaits_all
__global__ void parent_exec_scatter_kernel(
    unsigned* __restrict__ adj, int* __restrict__ ts,
    unsigned char* __restrict__ app, unsigned char* __restrict__ pend,
    unsigned char* __restrict__ aw, int cap, int words,
    const int* __restrict__ idx, int m, const unsigned* __restrict__ r_adj,
    const int* __restrict__ r_ts, const unsigned char* __restrict__ r_app,
    const unsigned char* __restrict__ r_pend,
    const unsigned char* __restrict__ r_aw) {
  const int cols = words + 6;
  const long long n = (long long)m * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int i = (int)(t / cols);
    const int c = (int)(t - (long long)i * cols);
    const int r = norm_index(idx[i], cap);
    if (r < 0) continue;
    if (c < words) {
      adj[(long long)r * words + c] = r_adj[(long long)i * words + c];
    } else if (c < words + 3) {
      const int k = c - words;
      ts[r * 3 + k] = r_ts[i * 3 + k];
    } else if (c == words + 3) {
      app[r] = r_app[i];
    } else if (c == words + 4) {
      pend[r] = r_pend[i];
    } else {
      aw[r] = r_aw[i];
    }
  }
}

// fresh lanes (d_*) = the arena (s_*) with rows idx[i] set from the row data
extern "C" int exec_scatter(void* d_adj, void* d_ts, void* d_app,
                            void* d_pend, void* d_aw, const void* s_adj,
                            const void* s_ts, const void* s_app,
                            const void* s_pend, const void* s_aw, int cap,
                            int words, const void* idx, int m,
                            const void* r_adj, const void* r_ts,
                            const void* r_app, const void* r_pend,
                            const void* r_aw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* dst[5] = {d_adj, d_ts, d_app, d_pend, d_aw};
  const void* src[5] = {s_adj, s_ts, s_app, s_pend, s_aw};
  const long long bytes[5] = {(long long)cap * words * 4, 12LL * cap, cap,
                              cap, cap};
  CopyTable t;
  for (int k = 0; k < 5; ++k) {
    t.src[k] = (const unsigned char*)src[k];
    t.dst[k] = (unsigned char*)dst[k];
    t.bytes[k] = bytes[k];
  }
  t.n = 5;
  int rc = launch_multi_copy(t, st);
  if (rc != 0) return rc;
  const long long n = (long long)m * (words + 6);
  if (n > 0) {
    parent_exec_scatter_kernel<<<grid_for(n, 256), 256, 0, st>>>(
        (unsigned*)d_adj, (int*)d_ts, (unsigned char*)d_app,
        (unsigned char*)d_pend, (unsigned char*)d_aw, cap, words,
        (const int*)idx, m, (const unsigned*)r_adj, (const int*)r_ts,
        (const unsigned char*)r_app, (const unsigned char*)r_pend,
        (const unsigned char*)r_aw);
    ACCORD_CHECK();
  }
  return 0;
}

// ---------------------------------------------------------------- K23
struct PShardMailTab {
  int* arena;
  int* meta;
  const unsigned char* part;
};

struct PShardDims {
  int S, t0, nt, bcap, w, rows_l, npsh, rows_nodes;
};

#define PMST 128

__device__ __forceinline__ int parent_shard_gather_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// position p of a launch over destinations t0 .. t0 + nt - 1 (receiver-
// major) -> its destination t, source s and send position q
__device__ __forceinline__ void parent_shard_pos(const PShardDims& d, int p, int* t,
                                          int* s, int* q) {
  const int seg = d.S * d.bcap;
  const int tl = p / seg;
  const int r = p - tl * seg;
  *t = d.t0 + tl;
  *s = r / d.bcap;
  const int j = r - *s * d.bcap;
  *q = (*s * d.S + *t) * d.bcap + j;
}

// the land flag of send lane q, on its source shard s whose partition
// rows [npsh, rows_nodes] start at part_rows
__device__ __forceinline__ bool parent_shard_land(const unsigned char* part_rows,
                                           const PShardDims& d, int s, int q,
                                           const int* src, const int* dst,
                                           const unsigned char* keep) {
  int loc = (int)((unsigned)src[q] - (unsigned)s * (unsigned)d.npsh);
  loc = loc < 0 ? 0 : (loc > d.npsh - 1 ? d.npsh - 1 : loc);
  const bool cut =
      part_rows[(long long)loc * d.rows_nodes +
                parent_shard_gather_index(dst[q], d.rows_nodes)] != 0;
  return keep[q] != 0 && !cut;
}

// the local ring row of a lane on destination shard t (rows_l: dropped),
// in the reference's wrapping int32 arithmetic
__device__ __forceinline__ int parent_shard_flat(const PShardDims& d, int t, int q,
                                          const int* dst, const int* slot,
                                          bool land) {
  const int depth = d.rows_l / d.npsh;
  const int loc = (int)((unsigned)dst[q] - (unsigned)t * (unsigned)d.npsh);
  if (!land || loc < 0 || loc >= d.npsh) return d.rows_l;
  return (int)((unsigned)loc * (unsigned)depth + (unsigned)slot[q]);
}

__device__ __forceinline__ void parent_shard_copy_row(int* __restrict__ dst,
                                               const int* __restrict__ src,
                                               int w) {
  if (((((uintptr_t)dst) | ((uintptr_t)src)) & 15u) == 0 && (w & 3) == 0) {
    for (int v = threadIdx.x; v < (w >> 2); v += blockDim.x)
      ((int4*)dst)[v] = ((const int4*)src)[v];
  } else {
    for (int v = threadIdx.x; v < w; v += blockDim.x) dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(PMST)
parent_mailbox_shard_scatter_kernel(const PShardMailTab* __restrict__ tab,
                             const PShardMailTab direct, const PShardDims d,
                             const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const int* __restrict__ slot,
                             const unsigned char* __restrict__ keep,
                             const int* __restrict__ kind,
                             const int* __restrict__ seq,
                             const int* __restrict__ words,
                             const unsigned char* __restrict__ land_in,
                             unsigned char* __restrict__ land_out) {
  const PShardMailTab m = tab ? *tab : direct;
  const int p = blockIdx.x;
  int t, s, q;
  parent_shard_pos(d, p, &t, &s, &q);
  const bool land =
      land_in != nullptr
          ? land_in[p] != 0
          : parent_shard_land(m.part + (long long)s * d.npsh * d.rows_nodes, d, s,
                       q, src, dst, keep);
  const int row = norm_index(parent_shard_flat(d, t, q, dst, slot, land), d.rows_l);
  const long long base = (long long)(t - d.t0) * d.rows_l;
  if (threadIdx.x == 0) {
    land_out[p] = land ? 1 : 0;
    if (row >= 0) {
      int* mt = m.meta + 3 * (base + row);
      mt[0] = src[q];
      mt[1] = kind[q];
      mt[2] = seq[q];
    }
  }
  if (row >= 0)
    parent_shard_copy_row(m.arena + (base + row) * d.w, words + (long long)q * d.w,
                   d.w);
}

__global__ void __launch_bounds__(PMST)
parent_mailbox_shard_gather_kernel(const PShardMailTab* __restrict__ tab,
                            const PShardMailTab direct, const PShardDims d,
                            const int* __restrict__ dst,
                            const int* __restrict__ slot,
                            const unsigned char* __restrict__ land,
                            int* __restrict__ landed,
                            int* __restrict__ landed_meta) {
  const PShardMailTab m = tab ? *tab : direct;
  const int p = blockIdx.x;
  int t, s, q;
  parent_shard_pos(d, p, &t, &s, &q);
  const int flat = parent_shard_flat(d, t, q, dst, slot, land[p] != 0);
  const int back = parent_shard_gather_index(flat < d.rows_l - 1 ? flat
                                                          : d.rows_l - 1,
                                      d.rows_l);
  const long long row = (long long)(t - d.t0) * d.rows_l + back;
  if (threadIdx.x < 3)
    landed_meta[3LL * p + threadIdx.x] = m.meta[3 * row + threadIdx.x];
  parent_shard_copy_row(landed + (long long)p * d.w, m.arena + row * d.w, d.w);
}

__global__ void parent_mailbox_shard_land_kernel(const unsigned char* part_rows,
                                          const PShardDims d, int s,
                                          const int* __restrict__ src,
                                          const int* __restrict__ dst,
                                          const unsigned char* keep,
                                          unsigned char* __restrict__ land) {
  const int n = d.S * d.bcap;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  land[i] = parent_shard_land(part_rows, d, s, s * n + i, src, dst, keep) ? 1 : 0;
}

extern "C" int mailbox_shard_tab_bytes() { return (int)sizeof(PShardMailTab); }

static inline bool parent_shard_dims_ok(const PShardDims& d) {
  return d.S > 0 && d.t0 >= 0 && d.nt > 0 && d.t0 + d.nt <= d.S &&
         d.bcap >= 0 && d.w > 0 && d.npsh > 0 && d.rows_l > 0 &&
         d.rows_l % d.npsh == 0 && d.rows_nodes == d.npsh * d.S;
}

// Scatter then gather-back for destination shards t0 .. t0 + nt - 1: the
// arena and meta hold those shards' rings (nt * rows_l rows, node-major),
// given directly or through `tab` (a device PShardMailTab; null: use
// arena/meta/part). land_in null: each land decision is made here from
// the partition mask `part` [rows_nodes, rows_nodes] (a shared device);
// else land_in[p] holds it (gathered from the source cards). Outputs at
// the launch's receiver-major positions p in [0, nt * S * bcap): landed
// [., w], landed_meta [., 3], land [.].
extern "C" int mailbox_shard_route(const void* tab, void* arena, void* meta,
                                   const void* part, const void* src,
                                   const void* dst, const void* slot,
                                   const void* keep, const void* kind,
                                   const void* seq, const void* words,
                                   const void* land_in, int S, int t0, int nt,
                                   int bcap, int w, int rows_l, int npsh,
                                   int rows_nodes, void* landed,
                                   void* landed_meta, void* land,
                                   void* stream) {
  const PShardDims d{S, t0, nt, bcap, w, rows_l, npsh, rows_nodes};
  if (!parent_shard_dims_ok(d)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)nt * S * bcap;
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  PShardMailTab direct;
  direct.arena = (int*)arena;
  direct.meta = (int*)meta;
  direct.part = (const unsigned char*)part;
  parent_mailbox_shard_scatter_kernel<<<(unsigned)n, PMST, 0, st>>>(
      (const PShardMailTab*)tab, direct, d, (const int*)src, (const int*)dst,
      (const int*)slot, (const unsigned char*)keep, (const int*)kind,
      (const int*)seq, (const int*)words, (const unsigned char*)land_in,
      (unsigned char*)land);
  ACCORD_CHECK();
  parent_mailbox_shard_gather_kernel<<<(unsigned)n, PMST, 0, st>>>(
      (const PShardMailTab*)tab, direct, d, (const int*)dst, (const int*)slot,
      (const unsigned char*)land, (int*)landed, (int*)landed_meta);
  ACCORD_CHECK();
  return 0;
}

// The land flags of source shard s's S * bcap send lanes (segments (s, 0)
// .. (s, S - 1), in send order), from its partition rows part_rows
// [npsh, rows_nodes] -- the half of the route that runs on the source
// card when the shards live on different cards.
extern "C" int mailbox_shard_land(const void* part_rows, int s, int S,
                                  int bcap, int npsh, int rows_nodes,
                                  const void* src, const void* dst,
                                  const void* keep, void* land,
                                  void* stream) {
  const PShardDims d{S, 0, S, bcap, 1, npsh, npsh, rows_nodes};
  if (!parent_shard_dims_ok(d) || s < 0 || s >= S) return (int)cudaErrorInvalidValue;
  const int n = S * bcap;
  if (n <= 0) return 0;
  parent_mailbox_shard_land_kernel<<<(n + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(
      (const unsigned char*)part_rows, d, s, (const int*)src,
      (const int*)dst, (const unsigned char*)keep, (unsigned char*)land);
  ACCORD_CHECK();
  return 0;
}
