// K4: generic row and word scatters with drop-on-out-of-range indices, and
// the fill-and-copy of arena growth.
//
// Replaces accord_tpu/ops/kernels.py `scatter_rows` (:242, the dirty-row
// lane delta behind ops/deltas.flush_lane), `kid_word_scatter` (:250, the
// per-key packed row-mask table), `arena_grow` (:864) and `range_scatter`
// (:852, the range arena's five lanes -- start, end, ts[3], kind, valid --
// copied by one launch and scattered by one launch, one thread per
// (dirty row, lane)).
//
// Functional, like the JAX kernels: each call writes a freshly allocated
// output, so the first launch copies the source lane and the second
// scatters at most 64 rows (or 1024 words) over it. What bounds it is the
// copy: bytes, the lane read once and written once (a [cap, 3] i32 lane is
// 192 KB at cap 16384, the kid table KC * cap/32 words is 2 MB at KC 1024).
// Duplicate indices carry identical data, so concurrent writes agree.
// K15 (lane_slice, the merged tick's per-plan window) is at the end.
#include "common.cuh"

__global__ void row_scatter_kernel(unsigned char* __restrict__ dst,
                                   int n_rows, int row_bytes,
                                   const int* __restrict__ idx, int m,
                                   const unsigned char* __restrict__ rows) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)m * row_bytes) return;
  int i = (int)(t / row_bytes);
  int c = (int)(t - (long long)i * row_bytes);
  int r = norm_index(idx[i], n_rows);
  if (r < 0) return;
  dst[(long long)r * row_bytes + c] = rows[(long long)i * row_bytes + c];
}

__global__ void word_scatter2d_kernel(unsigned* __restrict__ dst, int n0,
                                      int n1, const int* __restrict__ i0,
                                      const int* __restrict__ i1,
                                      const unsigned* __restrict__ vals,
                                      int z) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= z) return;
  int a = norm_index(i0[e], n0);
  int b = norm_index(i1[e], n1);
  if (a < 0 || b < 0) return;  // pad entries use kid == KC: dropped
  dst[(long long)a * n1 + b] = vals[e];
}

// dst = src with dst[idx[i]] = rows[i] (rows of row_bytes bytes)
extern "C" int row_scatter(void* dst, const void* src, int n_rows,
                           int row_bytes, const void* idx, int m,
                           const void* rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  launch_copy<unsigned char>((unsigned char*)dst, (const unsigned char*)src,
                             (long long)n_rows * row_bytes, st);
  ACCORD_CHECK();
  long long n = (long long)m * row_bytes;
  if (n > 0) {
    row_scatter_kernel<<<grid_for(n, 256), 256, 0, st>>>(
        (unsigned char*)dst, n_rows, row_bytes, (const int*)idx, m,
        (const unsigned char*)rows);
    ACCORD_CHECK();
  }
  return 0;
}

// dst = src [n0, n1] words with dst[i0[e], i1[e]] = vals[e]
extern "C" int word_scatter2d(void* dst, const void* src, int n0, int n1,
                              const void* i0, const void* i1,
                              const void* vals, int z, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  launch_copy<unsigned>((unsigned*)dst, (const unsigned*)src,
                        (long long)n0 * n1, st);
  ACCORD_CHECK();
  if (z > 0) {
    word_scatter2d_kernel<<<(z + 255) / 256, 256, 0, st>>>(
        (unsigned*)dst, n0, n1, (const int*)i0, (const int*)i1,
        (const unsigned*)vals, z);
    ACCORD_CHECK();
  }
  return 0;
}

// dst[:n_src] = src, dst[n_src:n_dst] = fill (32-bit elements)
extern "C" int grow_u32(void* dst, long long n_dst, const void* src,
                        long long n_src, int fill, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  copy_fill_kernel<unsigned><<<grid_for(n_dst, 256), 256, 0, st>>>(
      (unsigned*)dst, n_dst, (const unsigned*)src, n_src, (unsigned)fill);
  ACCORD_CHECK();
  return 0;
}

// the same over bytes (the bool valid lane)
extern "C" int grow_u8(void* dst, long long n_dst, const void* src,
                       long long n_src, int fill, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  copy_fill_kernel<unsigned char><<<grid_for(n_dst, 256), 256, 0, st>>>(
      (unsigned char*)dst, n_dst, (const unsigned char*)src, n_src,
      (unsigned char)fill);
  ACCORD_CHECK();
  return 0;
}

// the five range-arena lanes, in order: start, end (i32), ts (3 x i32),
// kind (i32), valid (u8); elements per row and element bytes of each
struct RangeLanes {
  unsigned char* dst[5];
  const unsigned char* src[5];
  const unsigned char* rows[5];
};
__constant__ int kRangeElem[5] = {4, 4, 12, 4, 1};
static const int kRangeBytes[5] = {4, 4, 12, 4, 1};

// one thread per (dirty row i, lane): dst[lane][rows[i]] = src_rows[lane][i]
__global__ void range_scatter_kernel(RangeLanes l, int rcap,
                                     const int* __restrict__ idx, int m) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * 5) return;
  int i = t / 5, lane = t - i * 5;
  int r = norm_index(idx[i], rcap);
  if (r < 0) return;
  int eb = kRangeElem[lane];
  for (int c = 0; c < eb; ++c)
    l.dst[lane][(long long)r * eb + c] = l.rows[lane][(long long)i * eb + c];
}

// fresh copies of the range lanes with rows idx[i] set from the row data
extern "C" int range_scatter(void* d_start, void* d_end, void* d_ts,
                             void* d_kind, void* d_valid, const void* s_start,
                             const void* s_end, const void* s_ts,
                             const void* s_kind, const void* s_valid,
                             int rcap, const void* idx, int m,
                             const void* r_start, const void* r_end,
                             const void* r_ts, const void* r_kind,
                             const void* r_valid, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  RangeLanes l{{(unsigned char*)d_start, (unsigned char*)d_end,
                (unsigned char*)d_ts, (unsigned char*)d_kind,
                (unsigned char*)d_valid},
               {(const unsigned char*)s_start, (const unsigned char*)s_end,
                (const unsigned char*)s_ts, (const unsigned char*)s_kind,
                (const unsigned char*)s_valid},
               {(const unsigned char*)r_start, (const unsigned char*)r_end,
                (const unsigned char*)r_ts, (const unsigned char*)r_kind,
                (const unsigned char*)r_valid}};
  CopyTable t;
  for (int k = 0; k < 5; ++k) {
    t.src[k] = l.src[k];
    t.dst[k] = l.dst[k];
    t.bytes[k] = (long long)kRangeBytes[k] * rcap;
  }
  t.n = 5;
  if (rcap > 0) {
    int rc = launch_multi_copy(t, st);
    if (rc != 0) return rc;
  }
  if (m > 0) {
    range_scatter_kernel<<<(m * 5 + 255) / 256, 256, 0, st>>>(
        l, rcap, (const int*)idx, m);
    ACCORD_CHECK();
  }
  return 0;
}

// K15: lane_slice, one plan's [rows x words] window of the merged packed
// result (accord_tpu/ops/node_lane.py `lane_slice` :190, a
// jax.lax.dynamic_slice). The offsets come from device memory when `offs`
// is set (offs[0] = row, offs[1] = word), so a captured launch replays
// with new offsets; else from r0 / w0. Like dynamic_slice, a negative
// start counts from the end, and each is clamped so the window stays
// inside [R, W]. What bounds it: bytes, the
// window read once and written once.
__global__ void lane_slice_kernel(const unsigned* __restrict__ src, int nr,
                                  int nw, const int* __restrict__ offs,
                                  int r0, int w0, int rows, int words,
                                  unsigned* __restrict__ out) {
  if (offs != nullptr) {
    r0 = offs[0];
    w0 = offs[1];
  }
  if (r0 < 0) r0 += nr;             // dynamic_slice: negative from the end
  if (w0 < 0) w0 += nw;
  r0 = min(max(r0, 0), nr - rows);
  w0 = min(max(w0, 0), nw - words);
  const long long n = (long long)rows * words;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = i / words;
    out[i] = src[(r0 + r) * nw + w0 + (i - r * words)];
  }
}

extern "C" int lane_slice(const void* src, int nr, int nw, const void* offs,
                          int r0, int w0, int rows, int words, void* out,
                          void* stream) {
  if (rows < 0 || words < 0 || rows > nr || words > nw)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || words == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  lane_slice_kernel<<<grid_for((long long)rows * words, 256), 256, 0, st>>>(
      (const unsigned*)src, nr, nw, (const int*)offs, r0, w0, rows, words,
      (unsigned*)out);
  ACCORD_CHECK();
  return 0;
}
