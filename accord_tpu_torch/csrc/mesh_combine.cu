// K22: the combining steps of the port's single-controller device mesh
// (accord_tpu_torch/parallel/mesh.py). Each shard of a sharded call runs
// an existing kernel at its shard-local offsets; its result is brought to
// the consumer's device (a no-op on a shared device, a peer copy between
// cards) and combined here. These replace the collectives of the JAX
// package's parallel/mesh.py:
//
//   or_fold         `psum(partial, 'model') > 0.5` of the sharded resolves
//                   (:200, :291, :351, :390) and of `sharded_deps_step`
//                   (:111). The shards' partials are already packed bits
//                   (or 0/1 bytes), so the merge is a bitwise OR: a sum
//                   would carry between bits. Witness, before and valid
//                   are the same on every 'model' shard, so
//                   OR_m pack(ov_m & rest) == pack(OR_m ov_m & rest).
//                   Each data shard's folded words land in its lane span
//                   of the output (lane order equals row order because
//                   every block's capacity is a multiple of 32 * data).
//   lane_concat     `_concat_lane_blocks` (:224): the per-store packed
//                   blocks of a fused call, side by side on the lane axis
//                   (up to CAT_SEGS blocks a launch).
//   counts_scan     `all_gather(counts_l, 'data')` and the prefix sums of
//                   `_sharded_finalize_body` (:609-616): the [data, S]
//                   per-shard slot counts -> indptr [S+1] and each shard's
//                   exclusive write base in every slot's segment, and the
//                   out-cap bound summed over its per-shard partials. One
//                   block of CT threads walks the slots CT at a time.
//   fragment_merge  the fragments' sum-merge (:654), then dep_ts =
//                   act_ts[dep_rows] (:656) and the checksum folded over
//                   the merged triple (csr_checksum, :657) with the
//                   padding past the total (merge_pad_fold_kernel).
//
// What bounds them on an H100: bytes, each combine reads its inputs once
// and writes its outputs once (a few hundred KB at the burn's shapes), so
// at those sizes a launch costs more than the copy.
#include "common.cuh"

// out[bi, out_off + d * wl + j] = OR_m parts[d][m][bi][j] (32-bit words)
__global__ void or_fold_kernel(const unsigned* __restrict__ parts, int data,
                               int model, int b, int wl,
                               unsigned* __restrict__ out, int out_stride,
                               int out_off) {
  const long long total = (long long)data * b * wl;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int j = (int)(e % wl);
    const long long r = e / wl;
    const int bi = (int)(r % b);
    const int d = (int)(r / b);
    unsigned v = 0u;
    for (int m = 0; m < model; ++m)
      v |= parts[(((long long)d * model + m) * b + bi) * wl + j];
    out[(long long)bi * out_stride + out_off + (long long)d * wl + j] = v;
  }
}

extern "C" int or_fold(const void* parts, int data, int model, int b, int wl,
                       void* out, int out_stride, int out_off, void* stream) {
  if (data <= 0 || model <= 0 || b <= 0 || wl <= 0) return 0;
  if (out_off < 0 || out_off + data * wl > out_stride)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)data * b * wl;
  or_fold_kernel<<<grid_for(total, 256), 256, 0, (cudaStream_t)stream>>>(
      (const unsigned*)parts, data, model, b, wl, (unsigned*)out, out_stride,
      out_off);
  ACCORD_CHECK();
  return 0;
}

#define CAT_SEGS 8

struct CatTable {
  const unsigned* src[CAT_SEGS];  // [b, w[k]] contiguous
  int w[CAT_SEGS];
  int off[CAT_SEGS];              // first output column
  int n;
  int total;                      // sum of w
};

__global__ void lane_concat_kernel(const __grid_constant__ CatTable t, int b,
                                   unsigned* __restrict__ out,
                                   int out_stride) {
  const long long total = (long long)b * t.total;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int bi = (int)(e / t.total);
    int c = (int)(e % t.total);
    int k = 0;
    while (c >= t.w[k]) c -= t.w[k++];
    out[(long long)bi * out_stride + t.off[k] + c] =
        t.src[k][(long long)bi * t.w[k] + c];
  }
}

// up to CAT_SEGS blocks src[k] [b, w[k]] into out[:, off[k] ...]
extern "C" int lane_concat(int n, const void* const* src, const int* w,
                           const int* off, int b, void* out, int out_stride,
                           void* stream) {
  if (n <= 0 || b <= 0) return 0;
  if (n > CAT_SEGS) return (int)cudaErrorInvalidValue;
  CatTable t{};
  t.n = n;
  for (int k = 0; k < n; ++k) {
    if (w[k] < 0 || off[k] < 0 || off[k] + w[k] > out_stride)
      return (int)cudaErrorInvalidValue;
    t.src[k] = (const unsigned*)src[k];
    t.w[k] = w[k];
    t.off[k] = off[k];
    t.total += w[k];
  }
  if (t.total == 0) return 0;
  lane_concat_kernel<<<grid_for((long long)b * t.total, 256), 256, 0,
                       (cudaStream_t)stream>>>(t, b, (unsigned*)out,
                                               out_stride);
  ACCORD_CHECK();
  return 0;
}

extern "C" int lane_concat_segs() { return CAT_SEGS; }

// counts [data, s] -> indptr [s+1] (exclusive prefix of the column sums,
// indptr[s] the total), seg_base [data, s] (indptr[i] + the lower shards'
// counts of slot i), bound = the sum of bounds [nb]; wrapping int32, as
// the reference's int32 cumsum
__global__ void __launch_bounds__(CT)
counts_scan_kernel(const int* __restrict__ counts, int data, int s,
                   const int* __restrict__ bounds, int nb,
                   int* __restrict__ indptr, int* __restrict__ seg_base,
                   int* __restrict__ bound) {
  unsigned carry = 0u;
  for (int lo = 0; lo < s; lo += CT) {
    const int i = lo + threadIdx.x;
    unsigned col = 0u;
    if (i < s)
      for (int d = 0; d < data; ++d) col += (unsigned)counts[(long long)d * s + i];
    int tot;
    const unsigned ex = carry + (unsigned)block_excl_scan((int)col, &tot);
    if (i < s) {
      indptr[i] = (int)ex;
      unsigned below = 0u;
      for (int d = 0; d < data; ++d) {
        seg_base[(long long)d * s + i] = (int)(ex + below);
        below += (unsigned)counts[(long long)d * s + i];
      }
    }
    carry += (unsigned)tot;
  }
  if (threadIdx.x == 0) {
    indptr[s] = (int)carry;
    unsigned bsum = 0u;
    for (int k = 0; k < nb; ++k) bsum += (unsigned)bounds[k];
    *bound = (int)bsum;
  }
}

extern "C" int counts_scan(const void* counts, int data, int s,
                           const void* bounds, int nb, void* indptr,
                           void* seg_base, void* bound, void* stream) {
  if (data <= 0 || s < 0 || nb < 0) return (int)cudaErrorInvalidValue;
  counts_scan_kernel<<<1, CT, 0, (cudaStream_t)stream>>>(
      (const int*)counts, data, s, (const int*)bounds, nb, (int*)indptr,
      (int*)seg_base, (int*)bound);
  ACCORD_CHECK();
  return 0;
}

// dep_rows[p] = sum_d frags[d][p]; dep_ts[p] = ts[dep_rows[p]] (a jnp
// gather: a negative row wraps once, then clamps)
__global__ void fragment_sum_kernel(const int* __restrict__ frags, int data,
                                    int out_cap, const int* __restrict__ ts,
                                    int ts_rows, int* __restrict__ dep_rows,
                                    int* __restrict__ dep_ts) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < out_cap; p += stride) {
    unsigned v = 0u;
    for (int d = 0; d < data; ++d)
      v += (unsigned)frags[(long long)d * out_cap + p];
    int r = (int)v;
    dep_rows[p] = r;
    if (r < 0) r += ts_rows;
    r = r < 0 ? 0 : (r >= ts_rows ? ts_rows - 1 : r);
    dep_ts[3 * p] = ts[3LL * r];
    dep_ts[3 * p + 1] = ts[3LL * r + 1];
    dep_ts[3 * p + 2] = ts[3LL * r + 2];
  }
}

// pad dep_rows (and dep_ts) past the total -- row 0, ts[0] -- and fold the
// finalize checksum grid-wide: each thread folds the value it reads (below
// the total) or writes (the padding), and each block adds its partial sums
// into acc[0..2] (wrapping u32 adds: the order cannot change the sum)
__global__ void __launch_bounds__(CT)
merge_pad_fold_kernel(int s, const int* __restrict__ ts, int out_cap,
                      const int* __restrict__ indptr,
                      int* __restrict__ dep_rows, int* __restrict__ dep_ts,
                      unsigned* __restrict__ acc) {
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
    s5 += fold_term(v, (unsigned)p, 5u);
  }
  const int pad[3] = {ts[0], ts[1], ts[2]};
  for (long long i = t; i < 3LL * out_cap; i += stride) {
    const int lane = (int)(i % 3);
    int v;
    if (i / 3 < start) {
      v = dep_ts[i];
    } else {
      v = lane == 0 ? pad[0] : (lane == 1 ? pad[1] : pad[2]);
      dep_ts[i] = v;
    }
    s9 += fold_term(v, (unsigned)i, 9u);
  }
  for (long long i = t; i <= s; i += stride)
    s1 += fold_term(indptr[i], (unsigned)i, 1u);
  block_sum3(s1, s5, s9);
  if (threadIdx.x == 0) {
    atomicAdd(&acc[0], s1);
    atomicAdd(&acc[1], s5);
    atomicAdd(&acc[2], s9);
  }
}

__global__ void merge_csum_kernel(const unsigned* __restrict__ acc,
                                  unsigned* __restrict__ csum) {
  *csum = acc[0] ^ acc[1] ^ acc[2];
}

// frags [data, out_cap] -> dep_rows [out_cap], dep_ts [out_cap, 3] and the
// checksum word over (indptr [s+1], dep_rows, dep_ts); acc: 3 u32 scratch
extern "C" int fragment_merge(const void* frags, int data, int out_cap,
                              const void* ts, int ts_rows, int s,
                              const void* indptr, void* dep_rows,
                              void* dep_ts, void* csum, void* acc,
                              void* stream) {
  if (data <= 0 || out_cap < 0 || ts_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (out_cap > 0) {
    fragment_sum_kernel<<<grid_for(out_cap, 256), 256, 0, st>>>(
        (const int*)frags, data, out_cap, (const int*)ts, ts_rows,
        (int*)dep_rows, (int*)dep_ts);
    ACCORD_CHECK();
  }
  cudaMemsetAsync(acc, 0, 3 * sizeof(unsigned), st);
  ACCORD_CHECK();
  long long work = 3LL * out_cap > (long long)s + 1 ? 3LL * out_cap : s + 1;
  int g = grid_for(work, CT);
  if (g > 1024) g = 1024;
  merge_pad_fold_kernel<<<g, CT, 0, st>>>(
      s, (const int*)ts, out_cap, (const int*)indptr, (int*)dep_rows,
      (int*)dep_ts, (unsigned*)acc);
  ACCORD_CHECK();
  merge_csum_kernel<<<1, 1, 0, st>>>((const unsigned*)acc, (unsigned*)csum);
  ACCORD_CHECK();
  return 0;
}
