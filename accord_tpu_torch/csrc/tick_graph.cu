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
// the table). Entry k is copied by the blocks with blockIdx.y == k, in
// 16-byte vectors when both ends are aligned, byte by byte otherwise.
#include "common.cuh"

struct CopyEnt {
  const unsigned char* src;
  unsigned char* dst;
  long long bytes;
};

extern "C" int copy_ent_bytes() { return (int)sizeof(CopyEnt); }

__global__ void table_copy_kernel(const CopyEnt* __restrict__ table) {
  const CopyEnt e = table[blockIdx.y];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long nv = 0;
  if ((((uintptr_t)e.src | (uintptr_t)e.dst) & 15u) == 0) nv = e.bytes >> 4;
  for (long long i = tid; i < nv; i += stride)
    ((uint4*)e.dst)[i] = ((const uint4*)e.src)[i];
  for (long long i = (nv << 4) + tid; i < e.bytes; i += stride)
    e.dst[i] = e.src[i];
}

// n entries at `table` (device memory); grid_x blocks per entry
extern "C" int table_copy(const void* table, int n, int grid_x,
                          void* stream) {
  if (n <= 0) return 0;
  if (n > 65535 || grid_x <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  table_copy_kernel<<<dim3(grid_x, n), 256, 0, st>>>(
      (const CopyEnt*)table);
  ACCORD_CHECK();
  return 0;
}
