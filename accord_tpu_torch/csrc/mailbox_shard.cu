// K23: the cross-shard mailbox route of the sharded protocol megakernel.
//
// Replaces accord_tpu/ops/mailbox.py `_sharded_mailbox_route_part` (:100),
// which the JAX sharded_protocol_tick (accord_tpu/parallel/mesh.py :821,
// builder :683) runs per 'data' shard inside a shard_map. The node lanes
// are padded so shard boundaries fall on node boundaries: node v lives on
// shard v / npsh, whose rings are rows [0, rows_l) of its arena slice
// (rows_l = npsh * depth; on a shared device slice t is rows [t * rows_l,
// (t + 1) * rows_l) of one node-major arena). The emit lanes are staged
// grouped by (source shard s, destination shard t): segment (s * S + t) of
// bcap lanes. For every (s, t) and lane j of the segment, with
// q = (s * S + t) * bcap + j the send position and
// p = (t * S + s) * bcap + j the receiver-major return position:
//   land[p]  = keep[q] & !part[s * npsh + clip(src[q] - s * npsh, 0,
//              npsh - 1), dst[q]]           (decided on the SOURCE shard,
//                                            from its partition rows; the
//                                            column gather wraps once,
//                                            then clamps)
//   flat     = land & 0 <= dst[q] - t * npsh < npsh
//              ? (dst[q] - t * npsh) * depth + slot[q] : rows_l
//   shard t's arena[flat] = words[q], meta[flat] = (src, kind, seq)
//                                           (.at[] rules: drop what is out
//                                            of range)
//   landed[p] = shard t's arena[min(flat, rows_l - 1)], landed_meta alike
//                                           (a non-landing lane reads the
//                                            LOCAL shard's last row)
// The reference's `lax.all_to_all` moves segment (s, t) to shard t; on a
// shared device that exchange is the index permutation q <-> p above, so
// the scatter reads each lane where it was staged. Between cards
// (mailbox_shard_land on each source card, a peer copy of each land
// segment, then mailbox_shard_route per destination card with land_in)
// only the land flags move: every card already holds the host-staged
// lanes.
//
// Inside the sharded megakernel's CUDA graph the arena, meta and
// partition pointers come from a device table (`tab`, as K17's MailTab),
// so the graph never bakes in a per-tick pointer. The gather-back is a
// second kernel in stream order, after the whole tick's scatter. Landed
// lanes name distinct (dst, slot) rows (MailboxPlane.stage_batch), so no
// two scatters collide.
//
// What bounds it: bytes -- each position's W payload words written once
// and gathered back once (S * S * bcap positions, most of them padding at
// S = 4); at burn sizes a launch. One block per position, threads
// striding over the words, 16-byte vectors where the rows allow.
#include "common.cuh"

struct ShardMailTab {
  int* arena;
  int* meta;
  const unsigned char* part;
};

struct ShardDims {
  int S, t0, nt, bcap, w, rows_l, npsh, rows_nodes;
};

#define MST 128

__device__ __forceinline__ int shard_gather_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// position p of a launch over destinations t0 .. t0 + nt - 1 (receiver-
// major) -> its destination t, source s and send position q
__device__ __forceinline__ void shard_pos(const ShardDims& d, int p, int* t,
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
__device__ __forceinline__ bool shard_land(const unsigned char* part_rows,
                                           const ShardDims& d, int s, int q,
                                           const int* src, const int* dst,
                                           const unsigned char* keep) {
  int loc = (int)((unsigned)src[q] - (unsigned)s * (unsigned)d.npsh);
  loc = loc < 0 ? 0 : (loc > d.npsh - 1 ? d.npsh - 1 : loc);
  const bool cut =
      part_rows[(long long)loc * d.rows_nodes +
                shard_gather_index(dst[q], d.rows_nodes)] != 0;
  return keep[q] != 0 && !cut;
}

// the local ring row of a lane on destination shard t (rows_l: dropped),
// in the reference's wrapping int32 arithmetic
__device__ __forceinline__ int shard_flat(const ShardDims& d, int t, int q,
                                          const int* dst, const int* slot,
                                          bool land) {
  const int depth = d.rows_l / d.npsh;
  const int loc = (int)((unsigned)dst[q] - (unsigned)t * (unsigned)d.npsh);
  if (!land || loc < 0 || loc >= d.npsh) return d.rows_l;
  return (int)((unsigned)loc * (unsigned)depth + (unsigned)slot[q]);
}

__device__ __forceinline__ void shard_copy_row(int* __restrict__ dst,
                                               const int* __restrict__ src,
                                               int w) {
  if (((((uintptr_t)dst) | ((uintptr_t)src)) & 15u) == 0 && (w & 3) == 0) {
    for (int v = threadIdx.x; v < (w >> 2); v += blockDim.x)
      ((int4*)dst)[v] = ((const int4*)src)[v];
  } else {
    for (int v = threadIdx.x; v < w; v += blockDim.x) dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(MST)
mailbox_shard_scatter_kernel(const ShardMailTab* __restrict__ tab,
                             const ShardMailTab direct, const ShardDims d,
                             const int* __restrict__ src,
                             const int* __restrict__ dst,
                             const int* __restrict__ slot,
                             const unsigned char* __restrict__ keep,
                             const int* __restrict__ kind,
                             const int* __restrict__ seq,
                             const int* __restrict__ words,
                             const unsigned char* __restrict__ land_in,
                             unsigned char* __restrict__ land_out) {
  const ShardMailTab m = tab ? *tab : direct;
  const int p = blockIdx.x;
  int t, s, q;
  shard_pos(d, p, &t, &s, &q);
  const bool land =
      land_in != nullptr
          ? land_in[p] != 0
          : shard_land(m.part + (long long)s * d.npsh * d.rows_nodes, d, s,
                       q, src, dst, keep);
  const int row = norm_index(shard_flat(d, t, q, dst, slot, land), d.rows_l);
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
    shard_copy_row(m.arena + (base + row) * d.w, words + (long long)q * d.w,
                   d.w);
}

__global__ void __launch_bounds__(MST)
mailbox_shard_gather_kernel(const ShardMailTab* __restrict__ tab,
                            const ShardMailTab direct, const ShardDims d,
                            const int* __restrict__ dst,
                            const int* __restrict__ slot,
                            const unsigned char* __restrict__ land,
                            int* __restrict__ landed,
                            int* __restrict__ landed_meta) {
  const ShardMailTab m = tab ? *tab : direct;
  const int p = blockIdx.x;
  int t, s, q;
  shard_pos(d, p, &t, &s, &q);
  const int flat = shard_flat(d, t, q, dst, slot, land[p] != 0);
  const int back = shard_gather_index(flat < d.rows_l - 1 ? flat
                                                          : d.rows_l - 1,
                                      d.rows_l);
  const long long row = (long long)(t - d.t0) * d.rows_l + back;
  if (threadIdx.x < 3)
    landed_meta[3LL * p + threadIdx.x] = m.meta[3 * row + threadIdx.x];
  shard_copy_row(landed + (long long)p * d.w, m.arena + row * d.w, d.w);
}

__global__ void mailbox_shard_land_kernel(const unsigned char* part_rows,
                                          const ShardDims d, int s,
                                          const int* __restrict__ src,
                                          const int* __restrict__ dst,
                                          const unsigned char* keep,
                                          unsigned char* __restrict__ land) {
  const int n = d.S * d.bcap;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  land[i] = shard_land(part_rows, d, s, s * n + i, src, dst, keep) ? 1 : 0;
}

extern "C" int mailbox_shard_tab_bytes() { return (int)sizeof(ShardMailTab); }

static inline bool shard_dims_ok(const ShardDims& d) {
  return d.S > 0 && d.t0 >= 0 && d.nt > 0 && d.t0 + d.nt <= d.S &&
         d.bcap >= 0 && d.w > 0 && d.npsh > 0 && d.rows_l > 0 &&
         d.rows_l % d.npsh == 0 && d.rows_nodes == d.npsh * d.S;
}

// Scatter then gather-back for destination shards t0 .. t0 + nt - 1: the
// arena and meta hold those shards' rings (nt * rows_l rows, node-major),
// given directly or through `tab` (a device ShardMailTab; null: use
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
  const ShardDims d{S, t0, nt, bcap, w, rows_l, npsh, rows_nodes};
  if (!shard_dims_ok(d)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)nt * S * bcap;
  if (n <= 0) return 0;
  if (n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  ShardMailTab direct;
  direct.arena = (int*)arena;
  direct.meta = (int*)meta;
  direct.part = (const unsigned char*)part;
  mailbox_shard_scatter_kernel<<<(unsigned)n, MST, 0, st>>>(
      (const ShardMailTab*)tab, direct, d, (const int*)src, (const int*)dst,
      (const int*)slot, (const unsigned char*)keep, (const int*)kind,
      (const int*)seq, (const int*)words, (const unsigned char*)land_in,
      (unsigned char*)land);
  ACCORD_CHECK();
  mailbox_shard_gather_kernel<<<(unsigned)n, MST, 0, st>>>(
      (const ShardMailTab*)tab, direct, d, (const int*)dst, (const int*)slot,
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
  const ShardDims d{S, 0, S, bcap, 1, npsh, npsh, rows_nodes};
  if (!shard_dims_ok(d) || s < 0 || s >= S) return (int)cudaErrorInvalidValue;
  const int n = S * bcap;
  if (n <= 0) return 0;
  mailbox_shard_land_kernel<<<(n + 255) / 256, 256, 0,
                              (cudaStream_t)stream>>>(
      (const unsigned char*)part_rows, d, s, (const int*)src,
      (const int*)dst, (const unsigned char*)keep, (unsigned char*)land);
  ACCORD_CHECK();
  return 0;
}
