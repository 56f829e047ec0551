// Shared helpers of the port's CUDA kernels (plain C interface, sm_90a).
//
// Conventions every kernel here keeps, so that each one matches its JAX
// reference bit for bit:
//   * packed row sets are 32-bit words, row 32*w + i in bit i of word w
//     (lowest row in the least significant bit); torch carries them as
//     int32 bit patterns, the kernels read them as unsigned;
//   * scatter indices follow jnp's `.at[]` rules: a negative index counts
//     from the end (i + n), and whatever is still outside [0, n) is
//     dropped, never written (padding sentinels such as cap, B or KC);
//   * each C entry point launches on the stream it is given, allocates
//     nothing, and returns cudaGetLastError() so the caller can raise.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define ACCORD_CHECK()                                   \
  do {                                                   \
    cudaError_t e_ = cudaGetLastError();                 \
    if (e_ != cudaSuccess) return (int)e_;               \
  } while (0)

extern "C" const char* accord_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}

// jnp .at[] index normalisation: -1 is the last element; -1 result = drop
__device__ __forceinline__ int norm_index(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// a < b lexicographically over three signed int32 lanes
__device__ __forceinline__ bool lex_before(int a0, int a1, int a2,
                                           int b0, int b1, int b2) {
  return (a0 < b0) || (a0 == b0 && ((a1 < b1) || (a1 == b1 && a2 < b2)));
}

// grid-stride copy of n elements
template <typename T>
__global__ void copy_kernel(T* __restrict__ dst, const T* __restrict__ src,
                            long long n) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride)
    dst[i] = src[i];
}

// copy n_src elements, then fill up to n_dst with `fill`
template <typename T>
__global__ void copy_fill_kernel(T* __restrict__ dst, long long n_dst,
                                 const T* __restrict__ src, long long n_src,
                                 T fill) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_dst; i += stride)
    dst[i] = i < n_src ? src[i] : fill;
}

static inline int grid_for(long long n, int threads) {
  long long g = (n + threads - 1) / threads;
  if (g < 1) g = 1;
  if (g > 8192) g = 8192;
  return (int)g;
}

// 16-byte vectors where both pointers and the size allow, else elements
template <typename T>
static inline void launch_copy(T* dst, const T* src, long long n,
                               cudaStream_t st) {
  if (n <= 0) return;
  long long bytes = n * (long long)sizeof(T);
  if (((uintptr_t)dst % 16 == 0) && ((uintptr_t)src % 16 == 0) &&
      bytes % 16 == 0) {
    long long nv = bytes / 16;
    copy_kernel<uint4><<<grid_for(nv, 256), 256, 0, st>>>(
        (uint4*)dst, (const uint4*)src, nv);
  } else {
    copy_kernel<T><<<grid_for(n, 256), 256, 0, st>>>(dst, src, n);
  }
}
