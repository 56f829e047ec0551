// K17: the device message plane's routing stage.
//
// Replaces accord_tpu/ops/mailbox.py `_mailbox_route_body` (:75), which the
// JAX protocol_tick fuses in at accord_tpu/ops/kernels.py:1377,1420-1421.
// Over the tick's L emit lanes:
//   land[i] = keep[i] & !part[src[i], dst[i]]      (gather rules: wrap once,
//                                                   then clamp)
//   flat[i] = land[i] ? dst[i]*depth + slot[i] : rows
//   arena[flat[i]] = words[i], meta[flat[i]] = (src, kind, seq)
//                                                  (.at[] rules: drop what
//                                                   is out of range)
//   landed_words[i] = arena[min(flat[i], rows-1)], landed_meta likewise
//                                                  (after the scatter)
// The arena and meta are updated IN PLACE (the plane owns them). Inside
// the protocol megakernel's CUDA graph their pointers, and the partition
// mask's, come from a device table (`tab`), so the graph never bakes in a
// per-tick pointer; a standalone call (tab null) passes them by value.
//
// The design (K23's, csrc/mailbox_shard.cu, on one ring set): the scatter
// and the gather-back in ONE launch. A block holds MW emit positions, a
// warp each. A warp whose lane lands (its flat in [0, rows), or in
// [-rows, 0), which wraps once) reads the lane's payload once and writes
// it from the same registers to its arena row and to its landed row, and
// its meta alike: it reads back its own row. Every other position gathers
// back one of two clamped rows: rows - 1 (a lane that does not land, or a
// landed flat >= rows) or row 0 (a flat < -rows). The reference reads
// those rows after the whole tick's scatter, and another lane of the
// launch may land on them, so no block uses an arena row that a block of
// the launch writes: a block with a reader scans the L index lanes (dst,
// slot and keep; src and the partition cut only of a lane naming one of
// the two rows) for the two rows' writers, and a reader takes its row's final words and meta from the writer's INPUT
// lanes, the old arena row only where no lane writes it. Landed lanes name
// distinct (dst, slot) rows (MailboxPlane.stage_batch), so a row has at
// most one writer. Before the scan each warp issues its loads -- its
// landing lane's payload, or its clamped row's old words and meta, dropped
// after the scan if a lane lands there -- so the scan runs under them.
//
// What bounds it: bytes -- each landed lane's W payload words read once
// and written twice (its ring row, its landed row), every other lane's
// landed row written once from one L2-resident clamped row (at the
// 1,024-lane tier with W = 384, ~3.1 MB out); at burn sizes, the launch.
// 16-byte vectors where the width and every row base allow.
#include "common.cuh"

struct MailTab {
  int* arena;
  int* meta;
  const unsigned char* part;
};

#define MW 8                  // positions a block, a warp each
#define MT (MW * 32)
#define MV 4                  // 16-byte vectors a lane loads at once

__device__ __forceinline__ int gather_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// the link's partition entry (gather rules: wrap once, then clamp)
__device__ __forceinline__ bool lane_cut(const MailTab& t, int s, int d,
                                         int n1) {
  return t.part[(long long)gather_index(s, n1) * n1 + gather_index(d, n1)] !=
         0;
}

// the flat arena row a landing lane names, in the reference's wrapping
// int32 arithmetic
__device__ __forceinline__ int land_flat(int d, int sl, int rows, int n1) {
  return (int)((unsigned)d * (unsigned)(rows / n1) + (unsigned)sl);
}

// a lane's first MV 16-byte vectors of a row (vector lane + 32 k), loaded
// together; and their store
__device__ __forceinline__ void row_load(const int* __restrict__ row, int nv,
                                         int lane, int4* buf) {
#pragma unroll
  for (int k = 0; k < MV; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) buf[k] = reinterpret_cast<const int4*>(row)[v];
  }
}

__device__ __forceinline__ void row_store(int* __restrict__ row, int nv,
                                          int lane, const int4* buf) {
#pragma unroll
  for (int k = 0; k < MV; ++k) {
    const int v = lane + 32 * k;
    if (v < nv) reinterpret_cast<int4*>(row)[v] = buf[k];
  }
}

// a warp's copy of a row past its first 32 * MV vectors (all of it, word
// by word, when not vec) to one or two rows (b may be null)
__device__ __forceinline__ void row_rest(const int* __restrict__ in,
                                         int* __restrict__ a,
                                         int* __restrict__ b, int w, bool vec,
                                         int lane) {
  if (vec) {
    for (int v = 32 * MV + lane; v < (w >> 2); v += 32) {
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

__global__ void __launch_bounds__(MT)
mailbox_route_kernel(const MailTab* __restrict__ tab, const MailTab direct,
                     const int* __restrict__ src,
                     const int* __restrict__ dst,
                     const int* __restrict__ slot,
                     const unsigned char* __restrict__ keep,
                     const int* __restrict__ kind,
                     const int* __restrict__ seq,
                     const int* __restrict__ words, int L, int w, int rows,
                     int n1, int* __restrict__ landed,
                     int* __restrict__ landed_meta,
                     unsigned char* __restrict__ land_out, int vec_io) {
  __shared__ int s_writer[2];   // the lane landing on row rows - 1 and on
                                // row 0, -1 none
  const MailTab t = tab ? *tab : direct;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * MW + (threadIdx.x >> 5);
  // 16-byte rows: the width and the caller's rows (vec_io), and the arena
  // (through the table, so checked here)
  const bool vec = vec_io && (reinterpret_cast<uintptr_t>(t.arena) & 15u) == 0;
  const int nv = vec ? w >> 2 : 0;
  // the index lanes of the warp's position and of the thread's first
  // scanned lane, loaded together (a position past L reads the last
  // lane's and is masked)
  const bool live = i < L;
  const int io = live ? i : L - 1;
  const int o_src = src[io], o_dst = dst[io], o_slot = slot[io];
  const unsigned char o_keep = keep[io];
  const int i0 = threadIdx.x < L ? threadIdx.x : L - 1;
  const int c_dst = dst[i0], c_slot = slot[i0];
  const unsigned char c_keep = keep[i0];
  if (threadIdx.x == 0) s_writer[0] = s_writer[1] = -1;
  // the warp's position: a landing lane writes row `row`; any other
  // gathers back clamped row `cr` (need 1: rows - 1, 2: row 0)
  const bool land = o_keep != 0 && !lane_cut(t, o_src, o_dst, n1);
  const int flat = land ? land_flat(o_dst, o_slot, rows, n1) : rows;
  int row = -1, need = 0;
  if (live) {
    row = norm_index(flat, rows);
    if (row < 0) need = flat >= rows ? 1 : 2;
  }
  const long long cr = need == 1 ? rows - 1 : 0;
  // loads issued before the scan: a landing lane's payload, or the clamped
  // row's old words and meta (what it gathers back unless a lane of this
  // launch lands there; then they are dropped, so reading them while that
  // lane's block writes the row is harmless)
  int4 buf[MV];
  int mv = 0;
  if (row >= 0) {
    row_load(words + (long long)i * w, nv, lane, buf);
    if (lane < 3) mv = lane == 0 ? o_src : (lane == 1 ? kind[i] : seq[i]);
  } else if (need) {
    row_load(t.arena + cr * w, nv, lane, buf);
    if (lane < 3) mv = t.meta[3 * cr + lane];
  }
  // the writers of the clamped rows, from the index lanes alone, where the
  // block has a reader: a kept lane naming one of the two rows, then (for
  // those few) its partition entry
  if (__syncthreads_or(need)) {
    for (int j = threadIdx.x; j < L; j += MT) {
      const bool first = j == threadIdx.x;
      const unsigned char kj = first ? c_keep : keep[j];
      const int rj = norm_index(
          land_flat(first ? c_dst : dst[j], first ? c_slot : slot[j], rows,
                    n1),
          rows);
      if (kj == 0 || (rj != rows - 1 && rj != 0) ||
          lane_cut(t, src[j], dst[j], n1))
        continue;
      if (rj == rows - 1) s_writer[0] = j;
      if (rj == 0) s_writer[1] = j;
    }
  }
  if (live && lane == 0) land_out[i] = land ? 1 : 0;
  if (row >= 0) {
    // it lands: its ring row and its landed row from the one read
    int* ring = t.arena + (long long)row * w;
    int* back = landed + (long long)i * w;
    row_store(ring, nv, lane, buf);
    row_store(back, nv, lane, buf);
    row_rest(words + (long long)i * w, ring, back, w, vec, lane);
    if (lane < 3) {
      t.meta[3LL * row + lane] = mv;
      landed_meta[3LL * i + lane] = mv;
    }
  }
  __syncthreads();
  if (!need) return;
  const int wj = s_writer[need - 1];
  const int* from = wj >= 0 ? words + (long long)wj * w : t.arena + cr * w;
  if (wj >= 0) {
    row_load(from, nv, lane, buf);
    if (lane < 3) mv = lane == 0 ? src[wj] : (lane == 1 ? kind[wj] : seq[wj]);
  }
  row_store(landed + (long long)i * w, nv, lane, buf);
  row_rest(from, landed + (long long)i * w, nullptr, w, vec, lane);
  if (lane < 3) landed_meta[3LL * i + lane] = mv;
}

extern "C" int mailbox_tab_bytes() { return (int)sizeof(MailTab); }

// tab: a device MailTab, or null to use (arena, meta, part) as given;
// lanes of L emits; W words a row; rows arena rows; n1 node lanes (the
// partition mask is bool[n1, n1]). ONE launch.
extern "C" int mailbox_route(const void* tab, void* arena, void* meta,
                             const void* part, const void* src,
                             const void* dst, const void* slot,
                             const void* keep, const void* kind,
                             const void* seq, const void* words, int L, int w,
                             int rows, int n1, void* landed,
                             void* landed_meta, void* land, void* stream) {
  if (L <= 0) return 0;
  if (rows <= 0 || n1 <= 0 || rows % n1 || w <= 0)
    return (int)cudaErrorInvalidValue;
  MailTab direct;
  direct.arena = (int*)arena;
  direct.meta = (int*)meta;
  direct.part = (const unsigned char*)part;
  const int vec_io = (w & 3) == 0 &&
                     ((((uintptr_t)words) | ((uintptr_t)landed)) & 15u) == 0;
  mailbox_route_kernel<<<(L + MW - 1) / MW, MT, 0, (cudaStream_t)stream>>>(
      (const MailTab*)tab, direct, (const int*)src, (const int*)dst,
      (const int*)slot, (const unsigned char*)keep, (const int*)kind,
      (const int*)seq, (const int*)words, L, w, rows, n1, (int*)landed,
      (int*)landed_meta, (unsigned char*)land, vec_io);
  ACCORD_CHECK();
  return 0;
}
