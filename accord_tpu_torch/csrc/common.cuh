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

// ---------------------------------------------------------------------------
// Segment compaction of packed row words into a CSR (K2 finalize_csr, K6
// range_finalize / segment_compact). A source `Src` exposes `int w` (words
// per segment) and `unsigned word(long long f, unsigned* kw) const`, the
// masked word at flat index f = segment * w + word, with *kw its bound
// contribution (0 where the caller counts the bound elsewhere). The set
// bits, in (segment, row) order, are the output rows. Four launches on one
// stream: (1) per-block popcount totals (+ the bound, by an exact int
// atomicAdd); (2) one block scans the block totals; (3) each block
// recomputes its words, scans them in shared memory and writes every set
// bit at global position p < out_cap to dep_rows (and dep_ts, gathered
// from ts), and indptr at each segment's first word; (4) the grid pads
// past the total (row 0, ts[0]) and folds the checksum, grid-wide: wrapping
// u32 partial sums added atomically, whose order cannot change the word.
#define CT 256          // threads per block
#define CI 4            // passes of CT consecutive words per block
#define CW (CT * CI)    // words per block

static inline int compact_blocks_for(long long n) {
  return (int)((n + CW - 1) / CW);
}

// block-wide exclusive scan of one int per thread (CT threads); *total =
// the block sum
__device__ __forceinline__ int block_excl_scan(int x, int* total) {
  __shared__ int warp_sums[CT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < CT / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    if (lane < CT / 32) warp_sums[lane] = v;  // inclusive warp prefix
  }
  __syncthreads();
  int before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[CT / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + incl - x;
}

template <class Src>
__global__ void __launch_bounds__(CT)
csr_count_kernel(const __grid_constant__ Src src, long long n,
                 int* __restrict__ block_sums,
                 int* __restrict__ bound) {
  long long base = (long long)blockIdx.x * CW;
  int cnt = 0, kb = 0;
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    long long f = base + (long long)i * CT + threadIdx.x;
    if (f < n) {
      unsigned kw;
      cnt += __popc(src.word(f, &kw));
      kb += __popc(kw);
    }
  }
  int tot_c, tot_k;
  block_excl_scan(cnt, &tot_c);
  block_excl_scan(kb, &tot_k);
  if (threadIdx.x == 0) {
    block_sums[blockIdx.x] = tot_c;
    if (bound != nullptr) atomicAdd(bound, tot_k);
  }
}

// one block: exclusive scan of the block totals; indptr[S] = grand total
__global__ void __launch_bounds__(CT)
csr_scan_kernel(const int* __restrict__ block_sums, int nblocks,
                int* __restrict__ block_off, int* __restrict__ indptr_end) {
  int carry = 0;
  for (int lo = 0; lo < nblocks; lo += CT) {
    int i = lo + threadIdx.x;
    int x = i < nblocks ? block_sums[i] : 0;
    int tot;
    int ex = block_excl_scan(x, &tot);
    if (i < nblocks) block_off[i] = carry + ex;
    carry += tot;
  }
  if (threadIdx.x == 0) *indptr_end = carry;
}

// ts == nullptr: no dep_ts lane (segment_compact)
template <class Src>
__global__ void __launch_bounds__(CT)
csr_expand_kernel(const __grid_constant__ Src src, long long n,
                  const int* __restrict__ block_off,
                  const int* __restrict__ ts, int out_cap,
                  int* __restrict__ indptr, int* __restrict__ dep_rows,
                  int* __restrict__ dep_ts) {
  long long base = (long long)blockIdx.x * CW;
  int carry = block_off[blockIdx.x];
  for (int i = 0; i < CI; ++i) {
    long long f = base + (long long)i * CT + threadIdx.x;
    unsigned v = 0u, kw;
    if (f < n) v = src.word(f, &kw);
    int tot;
    int pos = carry + block_excl_scan(__popc(v), &tot);
    carry += tot;
    if (f >= n) continue;
    int s = (int)(f / src.w);
    int w = (int)(f - (long long)s * src.w);
    if (w == 0) indptr[s] = pos;
    while (v && pos < out_cap) {
      int bit = __ffs(v) - 1;
      int row = (w << 5) + bit;
      dep_rows[pos] = row;
      if (ts != nullptr) {
        dep_ts[pos * 3] = ts[row * 3];
        dep_ts[pos * 3 + 1] = ts[row * 3 + 1];
        dep_ts[pos * 3 + 2] = ts[row * 3 + 2];
      }
      v &= v - 1u;
      ++pos;
    }
  }
}

__device__ __forceinline__ unsigned fold_term(int x, unsigned idx,
                                              unsigned seed) {
  unsigned v = (unsigned)x;
  v ^= v >> 16;
  return v * (2u * idx + seed);
}

__device__ __forceinline__ unsigned block_sum_u32(unsigned x) {
  __shared__ unsigned part[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
  if (lane == 0) part[warp] = x;
  __syncthreads();
  unsigned t = 0;
  if (warp == 0) {
    t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0u;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) t += __shfl_down_sync(0xffffffffu, t, d);
  }
  __syncthreads();
  return t;  // valid in thread 0
}

// the odd offsets of the checksum's position multipliers, per lane:
// indptr, dep_rows, dep_ts (finalize: 1 / 5 / 9; frontier: 13 / 17 / -)
struct FoldSeeds {
  unsigned i, r, t;
};

// pad dep_rows (and dep_ts) past the total -- row 0, ts[0] -- and fold the
// checksum grid-wide: each thread folds the value it reads (below the
// total) or writes (the padding), and each block adds its partial sums into
// acc[0..2] (wrapping u32 adds: the order cannot change the sum). acc ==
// nullptr pads and folds nothing more (no checksum); ts == nullptr has no
// dep_ts lane to pad or fold.
__global__ void __launch_bounds__(CT)
csr_pad_fold_kernel(int s, const int* __restrict__ ts, int out_cap,
                    const int* __restrict__ indptr, int* __restrict__ dep_rows,
                    int* __restrict__ dep_ts, unsigned* __restrict__ acc,
                    FoldSeeds seeds) {
  const int total = indptr[s];
  const int start = total < out_cap ? (total < 0 ? 0 : total) : out_cap;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned s1 = 0, s5 = 0, s9 = 0;
  for (long long p = t; p < out_cap; p += stride) {
    int v = 0;
    if (p < start)
      v = dep_rows[p];
    else
      dep_rows[p] = 0;
    s5 += fold_term(v, (unsigned)p, seeds.r);
  }
  if (acc == nullptr) return;  // uniform across the grid: no barrier skipped
  if (ts != nullptr) {
    const int pad[3] = {ts[0], ts[1], ts[2]};
    for (long long i = t; i < 3LL * out_cap; i += stride) {
      const int lane = (int)(i % 3);
      int v;
      if (i / 3 < start) {
        v = dep_ts[i];
      } else {
        v = pad[lane];
        dep_ts[i] = v;
      }
      s9 += fold_term(v, (unsigned)i, seeds.t);
    }
  }
  for (long long i = t; i <= s; i += stride)
    s1 += fold_term(indptr[i], (unsigned)i, seeds.i);
  s1 = block_sum_u32(s1);
  s5 = block_sum_u32(s5);
  s9 = block_sum_u32(s9);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], s1);
    atomicAdd(&acc[1], s5);
    atomicAdd(&acc[2], s9);
  }
}

__global__ void csr_csum_kernel(const unsigned* __restrict__ acc,
                                unsigned* __restrict__ csum) {
  *csum = acc[0] ^ acc[1] ^ acc[2];
}

// the compaction stages after the source words exist; *bound is zeroed by
// the caller when the source counts it; acc is 3 u32 of scratch, nullptr
// for no checksum (then csum is unused). Returns cudaGetLastError.
template <class Src>
static inline int launch_csr(const Src& src, int s, const int* ts,
                             int out_cap, int* indptr, int* dep_rows,
                             int* dep_ts, int* bound, unsigned* csum,
                             int* block_sums, int* block_off, unsigned* acc,
                             cudaStream_t st,
                             FoldSeeds seeds = FoldSeeds{1u, 5u, 9u}) {
  long long n = (long long)s * src.w;
  int nblocks = compact_blocks_for(n);
  if (n > 0) {
    csr_count_kernel<Src><<<nblocks, CT, 0, st>>>(src, n, block_sums, bound);
    ACCORD_CHECK();
  }
  csr_scan_kernel<<<1, CT, 0, st>>>(block_sums, n > 0 ? nblocks : 0,
                                    block_off, indptr + s);
  ACCORD_CHECK();
  if (n > 0) {
    csr_expand_kernel<Src><<<nblocks, CT, 0, st>>>(
        src, n, block_off, ts, out_cap, indptr, dep_rows, dep_ts);
    ACCORD_CHECK();
  }
  if (acc != nullptr) {
    cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned), st);
    ACCORD_CHECK();
  }
  long long work = 3LL * out_cap > (long long)s + 1 ? 3LL * out_cap : s + 1;
  int g = grid_for(work, CT);
  if (g > 1024) g = 1024;
  csr_pad_fold_kernel<<<g, CT, 0, st>>>(s, ts, out_cap, indptr, dep_rows,
                                        dep_ts, acc, seeds);
  ACCORD_CHECK();
  if (acc == nullptr) return 0;
  csr_csum_kernel<<<1, 1, 0, st>>>(acc, csum);
  ACCORD_CHECK();
  return 0;
}
