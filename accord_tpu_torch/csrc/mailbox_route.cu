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
// The arena and meta are updated IN PLACE (the plane owns them). Inside
// the protocol megakernel's CUDA graph their pointers, and the partition
// mask's, come from a device table (`tab`), so the graph never bakes in a
// per-tick pointer; a standalone call (tab null) passes them by value.
// The gather-back is a second kernel in stream order: a non-landing emit
// reads row rows-1 AFTER the whole tick's scatter (another emit may land
// there in the same tick). Landed emits name distinct (dst, slot) rows
// (MailboxPlane.stage_batch), so no two scatters collide.
//
// What bounds it: bytes -- each lane's W payload words written once and
// gathered back once (at the 1,024-lane tier with W = 384, ~6.3 MB); at
// burn sizes a launch (a few microseconds). One block per lane, threads
// striding over the words, 16-byte vectors where the rows allow.
#include "common.cuh"

struct MailTab {
  int* arena;
  int* meta;
  const unsigned char* part;
};

#define MT 128

__device__ __forceinline__ int gather_index(int i, int n) {
  if (i < 0) i += n;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ int lane_flat(const MailTab& t, const int* src,
                                         const int* dst, const int* slot,
                                         const unsigned char* keep, int i,
                                         int rows, int n1, bool* land) {
  const int s = src[i], d = dst[i];
  const bool cut = t.part[(long long)gather_index(s, n1) * n1 +
                          gather_index(d, n1)] != 0;
  *land = keep[i] != 0 && !cut;
  const int depth = rows / n1;
  // int32 wrap, as the reference's traced arithmetic
  return *land ? (int)((unsigned)d * (unsigned)depth + (unsigned)slot[i])
               : rows;
}

__device__ __forceinline__ void copy_row(int* __restrict__ dst,
                                         const int* __restrict__ src, int w) {
  if (((((uintptr_t)dst) | ((uintptr_t)src)) & 15u) == 0 && (w & 3) == 0) {
    for (int v = threadIdx.x; v < (w >> 2); v += blockDim.x)
      ((int4*)dst)[v] = ((const int4*)src)[v];
  } else {
    for (int v = threadIdx.x; v < w; v += blockDim.x) dst[v] = src[v];
  }
}

__global__ void __launch_bounds__(MT)
mailbox_scatter_kernel(const MailTab* __restrict__ tab, const MailTab direct,
                       const int* __restrict__ src,
                       const int* __restrict__ dst,
                       const int* __restrict__ slot,
                       const unsigned char* __restrict__ keep,
                       const int* __restrict__ kind,
                       const int* __restrict__ seq,
                       const int* __restrict__ words, int w, int rows,
                       int n1, unsigned char* __restrict__ land_out) {
  const MailTab t = tab ? *tab : direct;
  const int i = blockIdx.x;
  bool land;
  const int row = norm_index(
      lane_flat(t, src, dst, slot, keep, i, rows, n1, &land), rows);
  if (threadIdx.x == 0) {
    land_out[i] = land ? 1 : 0;
    if (row >= 0) {
      t.meta[3LL * row] = src[i];
      t.meta[3LL * row + 1] = kind[i];
      t.meta[3LL * row + 2] = seq[i];
    }
  }
  if (row >= 0)
    copy_row(t.arena + (long long)row * w, words + (long long)i * w, w);
}

__global__ void __launch_bounds__(MT)
mailbox_gather_kernel(const MailTab* __restrict__ tab, const MailTab direct,
                      const int* __restrict__ dst,
                      const int* __restrict__ slot,
                      const unsigned char* __restrict__ land, int w, int rows,
                      int n1, int* __restrict__ landed,
                      int* __restrict__ landed_meta) {
  const MailTab t = tab ? *tab : direct;
  const int i = blockIdx.x;
  const int depth = rows / n1;
  const int flat = land[i] ? (int)((unsigned)dst[i] * (unsigned)depth +
                                   (unsigned)slot[i])
                           : rows;
  const int back = gather_index(flat < rows - 1 ? flat : rows - 1, rows);
  if (threadIdx.x < 3)
    landed_meta[3LL * i + threadIdx.x] = t.meta[3LL * back + threadIdx.x];
  copy_row(landed + (long long)i * w, t.arena + (long long)back * w, w);
}

extern "C" int mailbox_tab_bytes() { return (int)sizeof(MailTab); }

// tab: a device MailTab, or null to use (arena, meta, part) as given;
// lanes of L emits; W words a row; rows arena rows; n1 node lanes (the
// partition mask is bool[n1, n1])
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
  cudaStream_t st = (cudaStream_t)stream;
  MailTab direct;
  direct.arena = (int*)arena;
  direct.meta = (int*)meta;
  direct.part = (const unsigned char*)part;
  mailbox_scatter_kernel<<<L, MT, 0, st>>>(
      (const MailTab*)tab, direct, (const int*)src, (const int*)dst,
      (const int*)slot, (const unsigned char*)keep, (const int*)kind,
      (const int*)seq, (const int*)words, w, rows, n1, (unsigned char*)land);
  ACCORD_CHECK();
  mailbox_gather_kernel<<<L, MT, 0, st>>>(
      (const MailTab*)tab, direct, (const int*)dst, (const int*)slot,
      (const unsigned char*)land, w, rows, n1, (int*)landed,
      (int*)landed_meta);
  ACCORD_CHECK();
  return 0;
}
