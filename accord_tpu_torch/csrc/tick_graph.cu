// The protocol megakernel's operand plumbing (ops/tick_graph.py): one
// launch copying a table of byte segments, read from device memory.
//
// A CUDA graph fixes every kernel argument at capture, but each cluster
// tick brings fresh arena snapshots and wants fresh outputs. The graph
// therefore opens with a copy of the host-written parameter block (the
// tables, the host lanes) into fixed device memory, then this kernel
// gathers the tick's device inputs (src = the tensor, dst = a fixed
// region), the stages run on fixed regions, and a last table_copy
// scatters their results into the tick's own output buffer (dst read from
// the table). Each entry has its own blocks, as many as its bytes need
// (TC_SLOTS 16-byte slots a block, at least one): entry k's are blocks
// [blk0, blk0 + its count). The table lists the n1 entries of one block
// first, so block b < n1 copies entry b, and a later block finds its
// entry by a binary search over the rest's blk0. A block copies in
// 16-byte vectors when both ends of its entry are aligned, byte by byte
// otherwise. (A fixed count of blocks an entry, as
// the largest entry needs, made a tick with one large output and many
// small ones launch blocks by the hundred thousand, nearly all idle: the
// sharded tick's packed result beside its 640 finalize outputs.)
#include "common.cuh"

#define TC_THREADS 256
#define TC_SLOTS (TC_THREADS * 4)   // 16-byte slots a block

struct CopyEnt {
  const unsigned char* src;
  unsigned char* dst;
  long long bytes;
  long long blk0;   // its first block
};

extern "C" int copy_ent_bytes() { return (int)sizeof(CopyEnt); }
extern "C" int table_copy_slots() { return TC_SLOTS; }

__global__ void __launch_bounds__(TC_THREADS)
table_copy_kernel(const CopyEnt* __restrict__ table, int n, int n1) {
  const long long b = blockIdx.x;
  int lo = b < n1 ? (int)b : n1, hi = b < n1 ? (int)b : n - 1;
  while (lo < hi) {   // the entry: the last whose blk0 <= b
    const int mid = (lo + hi + 1) >> 1;
    if (table[mid].blk0 <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  const CopyEnt e = table[lo];
  const long long ns = (e.bytes + 15) >> 4;
  const long long j0 = (b - e.blk0) * TC_SLOTS;
  const long long j1 = j0 + TC_SLOTS < ns ? j0 + TC_SLOTS : ns;
  const bool vec = (((uintptr_t)e.src | (uintptr_t)e.dst) & 15u) == 0;
  for (long long j = j0 + threadIdx.x; j < j1; j += TC_THREADS) {
    const long long off = j << 4;
    if (vec && off + 16 <= e.bytes) {
      ((uint4*)e.dst)[j] = ((const uint4*)e.src)[j];
    } else {
      const long long end = off + 16 < e.bytes ? off + 16 : e.bytes;
      for (long long q = off; q < end; ++q) e.dst[q] = e.src[q];
    }
  }
}

// n entries at `table` (device memory), the first n1 of one block, their
// blk0 set; `blocks` blocks (every entry's max(1, ceil(slots /
// table_copy_slots())), summed)
extern "C" int table_copy(const void* table, int n, int n1, int blocks,
                          void* stream) {
  if (n <= 0) return 0;
  if (blocks < n || n1 < 0 || n1 > n) return (int)cudaErrorInvalidValue;
  table_copy_kernel<<<blocks, TC_THREADS, 0, (cudaStream_t)stream>>>(
      (const CopyEnt*)table, n, n1);
  ACCORD_CHECK();
  return 0;
}
