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
// so the graph never bakes in a per-tick pointer.
//
// The design: scatter and gather-back in ONE launch. A block holds MSW
// positions of one destination shard, a warp each. A warp whose lane
// lands reads the lane's payload once and writes it from the same
// registers to its arena row and to its landed row, and its meta alike.
// Every other position gathers back one of two clamped rows of its
// destination shard: rows_l - 1 (a non-landing lane, padding, or a landed
// flat past the ring: flat >= rows_l) or row 0 (flat < -rows_l; a flat in
// [-rows_l, 0) wraps once and writes, and so reads back, its own row).
// The reference reads those rows after the whole tick's scatter, and
// another lane of the launch may land on them, so no block uses an arena
// row that a block of the launch writes: every block scans its shard's S
// * bcap index lanes (dst, slot, keep and the land decision) for the two
// rows' writers, and a reader takes its row's final words and meta from
// the writer's INPUT lanes, the old arena row only where no lane writes
// it. Landed lanes name distinct (dst, slot) rows
// (MailboxPlane.stage_batch), so a row has at most one writer. Before the
// scan each warp issues its loads -- its landing lane's payload, or its
// clamped row's old words and meta, dropped after the scan if a lane
// lands there -- so the scan runs under them.
//
// What bounds it: bytes -- each landed lane's W payload words read once
// and written twice (its ring row, its landed row), every position's
// landed row written once (S * S * bcap positions, most of them padding
// at S = 4, whose rows come from one L2-resident clamped row); at burn
// sizes, the launch. 16-byte vectors where the rows allow.
#include "common.cuh"

struct ShardMailTab {
  int* arena;
  int* meta;
  const unsigned char* part;
};

struct ShardDims {
  int S, t0, nt, bcap, w, rows_l, npsh, rows_nodes;
};

#define MSW 8                 // positions a block, a warp each
#define MST (MSW * 32)
#define MRV 4                 // 16-byte vectors a lane loads at once

__device__ __forceinline__ int shard_gather_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// the partition entry of the link from source shard s's node src to dst,
// in that shard's partition rows part_rows [npsh, rows_nodes] (src
// clipped to the shard's nodes; the column gather wraps once, then clamps)
__device__ __forceinline__ unsigned char shard_cut(
    const unsigned char* part_rows, const ShardDims& d, int s, int src,
    int dst) {
  int loc = (int)((unsigned)src - (unsigned)s * (unsigned)d.npsh);
  loc = loc < 0 ? 0 : (loc > d.npsh - 1 ? d.npsh - 1 : loc);
  return part_rows[(long long)loc * d.rows_nodes +
                   shard_gather_index(dst, d.rows_nodes)];
}

// position pl of destination shard t's segment (launch position p): its
// source shard s, send lane q and index lanes, loaded together (flag: its
// keep, or with land_in its land flag from the source card)
struct ShardLane {
  int s, q, src, dst, slot, flag;
};

__device__ __forceinline__ ShardLane shard_lane_load(
    const ShardDims& d, int t, int pl, long long p, const int* src,
    const int* dst, const int* slot, const unsigned char* keep,
    const unsigned char* land_in) {
  ShardLane l;
  l.s = pl / d.bcap;
  l.q = (l.s * d.S + t) * d.bcap + (pl - l.s * d.bcap);
  l.flag = land_in != nullptr ? land_in[p] : keep[l.q];
  l.src = src[l.q];
  l.dst = dst[l.q];
  l.slot = slot[l.q];
  return l;
}

// the partition entry of the lane's link, in the full mask (read whatever
// its keep, so that no branch holds the load back)
__device__ __forceinline__ unsigned char shard_lane_cut(
    const ShardMailTab& m, const ShardDims& d, const ShardLane& l) {
  return shard_cut(m.part + (long long)l.s * d.npsh * d.rows_nodes, d, l.s,
                   l.src, l.dst);
}

// its land decision and its local ring row on shard t (rows_l: dropped),
// in the reference's wrapping int32 arithmetic
__device__ __forceinline__ int shard_flat(const ShardDims& d, int t,
                                          const ShardLane& l,
                                          unsigned char cut, bool given,
                                          bool* land) {
  *land = l.flag != 0 && (given || cut == 0);
  const int depth = d.rows_l / d.npsh;
  const int loc = (int)((unsigned)l.dst - (unsigned)t * (unsigned)d.npsh);
  if (!*land || loc < 0 || loc >= d.npsh) return d.rows_l;
  return (int)((unsigned)loc * (unsigned)depth + (unsigned)l.slot);
}

// a lane's first MRV 16-byte vectors of a row (vector lane + 32 k), loaded
// together
__device__ __forceinline__ void shard_row_load(const int* __restrict__ row,
                                               int nv, int lane, int4* buf) {
#pragma unroll
  for (int k = 0; k < MRV; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) buf[k] = reinterpret_cast<const int4*>(row)[v];
  }
}

__device__ __forceinline__ void shard_row_store(int* __restrict__ row, int nv,
                                                int lane, const int4* buf) {
#pragma unroll
  for (int k = 0; k < MRV; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) reinterpret_cast<int4*>(row)[v] = buf[k];
  }
}

// a warp's copy of a row past its first 32 * MRV vectors (all of it: from
// 0 when not vec) to one or two rows (b may be null)
__device__ __forceinline__ void shard_row_rest(const int* __restrict__ in,
                                               int* __restrict__ a,
                                               int* __restrict__ b, int w,
                                               bool vec, int lane) {
  if (vec) {
    for (int v = 32 * MRV + lane; v < (w >> 2); v += 32) {
      const int4 x = reinterpret_cast<const int4*>(in)[v];
      reinterpret_cast<int4*>(a)[v] = x;
      if (b) reinterpret_cast<int4*>(b)[v] = x;
    }
  } else {
    for (int v = lane; v < w; v += 32) {
      const int x = in[v];
      a[v] = x;
      if (b) b[v] = x;
    }
  }
}

__global__ void __launch_bounds__(MST)
mailbox_shard_route_kernel(const ShardMailTab* __restrict__ tab,
                           const ShardMailTab direct, const ShardDims d,
                           const int* __restrict__ src,
                           const int* __restrict__ dst,
                           const int* __restrict__ slot,
                           const unsigned char* __restrict__ keep,
                           const int* __restrict__ kind,
                           const int* __restrict__ seq,
                           const int* __restrict__ words,
                           const unsigned char* __restrict__ land_in,
                           int* __restrict__ landed,
                           int* __restrict__ landed_meta,
                           unsigned char* __restrict__ land_out, int vec) {
  __shared__ int s_writer[2];   // the send lane landing on row rows_l - 1
                                // and on row 0, -1 none
  const ShardMailTab m = tab ? *tab : direct;
  const int lane = threadIdx.x & 31;
  const int tl = blockIdx.y;
  const int t = d.t0 + tl;
  const int seg = d.S * d.bcap;
  const int pl = blockIdx.x * MSW + (threadIdx.x >> 5);
  const long long base = (long long)tl * d.rows_l;   // shard t's row 0
  const long long p = (long long)tl * seg + pl;
  const int nv = vec ? d.w >> 2 : 0;
  const bool given = land_in != nullptr;
  // the index lanes of the warp's position and of the thread's first
  // scanned position, loaded together (a position past the segment reads
  // the last one's and is masked)
  const bool live = pl < seg;
  const int po = live ? pl : seg - 1;
  const ShardLane own = shard_lane_load(d, t, po, (long long)tl * seg + po,
                                        src, dst, slot, keep, land_in);
  const int i0 = threadIdx.x < seg ? threadIdx.x : seg - 1;
  const ShardLane sc = shard_lane_load(d, t, i0, (long long)tl * seg + i0,
                                       src, dst, slot, keep, land_in);
  if (threadIdx.x == 0) s_writer[0] = s_writer[1] = -1;
  __syncthreads();
  // the partition entries (none with land_in: `part` then holds this
  // card's rows only)
  unsigned char own_cut = 0, sc_cut = 0;
  if (!given) {
    own_cut = shard_lane_cut(m, d, own);
    sc_cut = shard_lane_cut(m, d, sc);
  }
  // the warp's position: a landing lane writes row `row` of shard t; any
  // other gathers back clamped row `cr` (need 1: rows_l - 1, 2: row 0)
  bool land;
  const int flat = shard_flat(d, t, own, own_cut, given, &land);
  const int q = own.q;
  int row = -1, need = 0;
  if (live) {
    row = norm_index(flat, d.rows_l);
    if (row < 0) need = flat >= d.rows_l ? 1 : 2;
  }
  const long long cr = base + (need == 1 ? d.rows_l - 1 : 0);
  // loads issued before the scan: a landing lane's payload, or the clamped
  // row's old words and meta (what it gathers back unless a lane of this
  // launch lands there; then they are dropped, so reading them while that
  // lane's block writes the row is harmless)
  int4 buf[MRV];
  int mv = 0;
  if (row >= 0) {
    shard_row_load(words + (long long)q * d.w, nv, lane, buf);
    if (lane < 3) mv = lane == 0 ? own.src : (lane == 1 ? kind[q] : seq[q]);
  } else if (need) {
    shard_row_load(m.arena + cr * d.w, nv, lane, buf);
    if (lane < 3) mv = m.meta[3 * cr + lane];
  }
  // the writers of the clamped rows, from the index lanes alone
  for (int i = threadIdx.x; i < seg; i += MST) {
    bool li;
    int ri;
    int qi = sc.q;
    if (i == threadIdx.x) {
      ri = norm_index(shard_flat(d, t, sc, sc_cut, given, &li), d.rows_l);
    } else {
      const ShardLane l = shard_lane_load(d, t, i, (long long)tl * seg + i,
                                          src, dst, slot, keep, land_in);
      ri = norm_index(
          shard_flat(d, t, l, given ? 0 : shard_lane_cut(m, d, l), given,
                     &li),
          d.rows_l);
      qi = l.q;
    }
    if (ri == d.rows_l - 1) s_writer[0] = qi;
    if (ri == 0) s_writer[1] = qi;
  }
  if (pl < seg && lane == 0) land_out[p] = land ? 1 : 0;
  if (row >= 0) {
    // it lands: its ring row and its landed row from the one read
    const long long r = base + row;
    shard_row_store(m.arena + r * d.w, nv, lane, buf);
    shard_row_store(landed + p * d.w, nv, lane, buf);
    shard_row_rest(words + (long long)q * d.w, m.arena + r * d.w,
                   landed + p * d.w, d.w, vec, lane);
    if (lane < 3) {
      m.meta[3 * r + lane] = mv;
      landed_meta[3 * p + lane] = mv;
    }
  }
  __syncthreads();
  if (!need) return;
  const int wq = s_writer[need - 1];
  const int* from = wq >= 0 ? words + (long long)wq * d.w : m.arena + cr * d.w;
  if (wq >= 0) {
    shard_row_load(from, nv, lane, buf);
    if (lane < 3) mv = lane == 0 ? src[wq] : (lane == 1 ? kind[wq] : seq[wq]);
  }
  shard_row_store(landed + p * d.w, nv, lane, buf);
  shard_row_rest(from, landed + p * d.w, nullptr, d.w, vec, lane);
  if (lane < 3) landed_meta[3 * p + lane] = mv;
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
  const int q = s * n + i;
  land[i] = keep[q] != 0 && shard_cut(part_rows, d, s, src[q], dst[q]) == 0;
}

extern "C" int mailbox_shard_tab_bytes() { return (int)sizeof(ShardMailTab); }

static inline bool shard_dims_ok(const ShardDims& d) {
  return d.S > 0 && d.t0 >= 0 && d.nt > 0 && d.t0 + d.nt <= d.S &&
         d.bcap >= 0 && d.w > 0 && d.npsh > 0 && d.rows_l > 0 &&
         d.rows_l % d.npsh == 0 && d.rows_nodes == d.npsh * d.S;
}

// Scatter and gather-back, ONE launch, for destination shards t0 .. t0 +
// nt - 1: the
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
  ShardMailTab direct;
  direct.arena = (int*)arena;
  direct.meta = (int*)meta;
  direct.part = (const unsigned char*)part;
  // 16-byte rows where the width and every row base allow (the arena's
  // through `tab` is the graph's own node-major tensor, as aligned as the
  // one given)
  const int vec = (w & 3) == 0 &&
                  ((((uintptr_t)words) | ((uintptr_t)landed) |
                    (tab ? 0 : (uintptr_t)arena)) & 15u) == 0;
  const dim3 grid((unsigned)((S * bcap + MSW - 1) / MSW), (unsigned)nt);
  mailbox_shard_route_kernel<<<grid, MST, 0, (cudaStream_t)stream>>>(
      (const ShardMailTab*)tab, direct, d, (const int*)src, (const int*)dst,
      (const int*)slot, (const unsigned char*)keep, (const int*)kind,
      (const int*)seq, (const int*)words, (const unsigned char*)land_in,
      (int*)landed, (int*)landed_meta, (unsigned char*)land, vec);
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
