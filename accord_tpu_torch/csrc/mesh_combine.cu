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
//                   block of 1,024 threads, 4 slots a thread a pass.
//   fragment_merge  the fragments' sum-merge (:654), then dep_ts =
//                   act_ts[dep_rows] (:656) and the checksum folded over
//                   the merged triple (csr_checksum, :657): ONE launch,
//                   one pass over out_cap, the last block by ticket
//                   writing the checksum.
// counts_scan and fragment_merge serve the eager sharded finalize (the
// form that shards across cards); the sharded megakernel's graph runs its
// finalizes as one table launch (csrc/finalize_csr.cu fin_shard_tab).
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
// the reference's int32 cumsum. One block of CS_T threads, CS_U
// consecutive slots a thread a pass (4,096 slots, the PreAccept batch's,
// in one pass): a thread issues its slots' loads of every shard's counts
// before it sums them (was a block of CT threads, a slot each, walking
// the slots CT at a time: 16 dependent passes at the batch).
#define CS_T 1024
#define CS_U 4

// block-wide exclusive scan of one u32 a thread (CS_T threads); *total =
// the block sum
__device__ __forceinline__ unsigned cs_excl_scan(unsigned x,
                                                 unsigned* total) {
  __shared__ unsigned ws[CS_T / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    unsigned v = ws[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += y;
    }
    ws[lane] = v;
  }
  __syncthreads();
  const unsigned before = warp == 0 ? 0u : ws[warp - 1];
  *total = ws[CS_T / 32 - 1];
  __syncthreads();   // ws is reused by the next pass
  return before + incl - x;
}

__global__ void __launch_bounds__(CS_T)
counts_scan_kernel(const int* __restrict__ counts, int data, int s,
                   const int* __restrict__ bounds, int nb,
                   int* __restrict__ indptr, int* __restrict__ seg_base,
                   int* __restrict__ bound) {
  unsigned carry = 0u;
  for (long long lo = 0; lo < s; lo += CS_T * CS_U) {
    const long long i0 = lo + (long long)threadIdx.x * CS_U;
    unsigned col[CS_U];
#pragma unroll
    for (int u = 0; u < CS_U; ++u) col[u] = 0u;
#pragma unroll 4
    for (int d = 0; d < data; ++d) {
      const int* c = counts + (long long)d * s;
#pragma unroll
      for (int u = 0; u < CS_U; ++u)
        if (i0 + u < s) col[u] += (unsigned)c[i0 + u];
    }
    unsigned mine = 0u, tot;
#pragma unroll
    for (int u = 0; u < CS_U; ++u) mine += col[u];
    unsigned ex = carry + cs_excl_scan(mine, &tot);
#pragma unroll
    for (int u = 0; u < CS_U; ++u) {
      const long long i = i0 + u;
      if (i >= s) break;
      indptr[i] = (int)ex;
      unsigned below = 0u;
      for (int d = 0; d < data; ++d) {
        seg_base[(long long)d * s + i] = (int)(ex + below);
        below += (unsigned)counts[(long long)d * s + i];
      }
      ex += col[u];
    }
    carry += tot;
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
  counts_scan_kernel<<<1, CS_T, 0, (cudaStream_t)stream>>>(
      (const int*)counts, data, s, (const int*)bounds, nb, (int*)indptr,
      (int*)seg_base, (int*)bound);
  ACCORD_CHECK();
  return 0;
}

// The fragments' merge in ONE launch (was a sum kernel, a memset of the
// checksum's partial sums, a pad/fold kernel and a one-thread checksum
// kernel): a thread takes MG_U positions a pass (p, p + stride, ...),
// issues every fragment load of them, then their dep_ts gathers from ts (a
// jnp gather: a negative row wraps once, then clamps), and writes and
// folds both; the padding past the total is the fragments' zeros there and
// ts[0], written by the same walk. The indptr words fold in the same
// launch (a thread's first one loaded before any fragment). Each block adds its partial sums into zeroed scratch and takes
// a ticket; the last block writes the checksum word and zeroes the scratch
// again. A merge of at most CT * MG_U positions is one block, which writes
// the checksum from its own sums and leaves the scratch alone (a burn's
// merge: its latency is the launch and two dependent loads).
#define MG_U 4

struct MergeScratch {
  unsigned acc[3];   // indptr, dep_rows, dep_ts partial sums
  unsigned ticket;
};

__global__ void __launch_bounds__(CT)
fragment_merge_kernel(const int* __restrict__ frags, int data, int out_cap,
                      const int* __restrict__ ts, int ts_rows, int s,
                      const int* __restrict__ indptr,
                      int* __restrict__ dep_rows, int* __restrict__ dep_ts,
                      unsigned* __restrict__ csum, MergeScratch* sc) {
  __shared__ bool s_last;
  const long long stride = (long long)gridDim.x * CT;
  const long long t = (long long)blockIdx.x * CT + threadIdx.x;
  unsigned s1 = 0u, s5 = 0u, s9 = 0u;
  // the thread's first indptr word, loaded before the fragments' (its
  // latency hides behind theirs), folded after
  const int y0 = t <= s ? indptr[t] : 0;
  for (long long p0 = t; p0 < out_cap; p0 += MG_U * stride) {
    unsigned v[MG_U];
#pragma unroll
    for (int u = 0; u < MG_U; ++u) v[u] = 0u;
    for (int d = 0; d < data; ++d) {
      const int* f = frags + (long long)d * out_cap;
#pragma unroll
      for (int u = 0; u < MG_U; ++u) {
        const long long p = p0 + u * stride;
        if (p < out_cap) v[u] += (unsigned)f[p];
      }
    }
    int x[MG_U][3];
#pragma unroll
    for (int u = 0; u < MG_U; ++u) {
      int r = (int)v[u];
      if (r < 0) r += ts_rows;
      r = r < 0 ? 0 : (r >= ts_rows ? ts_rows - 1 : r);
      if (p0 + u * stride < out_cap) {
#pragma unroll
        for (int l = 0; l < 3; ++l) x[u][l] = ts[3LL * r + l];
      }
    }
#pragma unroll
    for (int u = 0; u < MG_U; ++u) {
      const long long p = p0 + u * stride;
      if (p >= out_cap) break;
      dep_rows[p] = (int)v[u];
      s5 += fold_term((int)v[u], (unsigned)p, 5u);
#pragma unroll
      for (int l = 0; l < 3; ++l) {
        dep_ts[3 * p + l] = x[u][l];
        s9 += fold_term(x[u][l], (unsigned)(3 * p + l), 9u);
      }
    }
  }
  if (t <= s) s1 += fold_term(y0, (unsigned)t, 1u);
  for (long long i = t + stride; i <= s; i += stride)
    s1 += fold_term(indptr[i], (unsigned)i, 1u);
  block_sum3(s1, s5, s9);
  if (gridDim.x == 1) {
    if (threadIdx.x == 0) *csum = s1 ^ s5 ^ s9;
    return;
  }
  if (threadIdx.x == 0) {
    atomicAdd(&sc->acc[0], s1);
    atomicAdd(&sc->acc[1], s5);
    atomicAdd(&sc->acc[2], s9);
    __threadfence();
    s_last = atomicAdd(&sc->ticket, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!s_last || threadIdx.x != 0) return;
  __threadfence();
  *csum = __ldcg(&sc->acc[0]) ^ __ldcg(&sc->acc[1]) ^ __ldcg(&sc->acc[2]);
  sc->acc[0] = 0u;
  sc->acc[1] = 0u;
  sc->acc[2] = 0u;
  sc->ticket = 0u;
}

extern "C" int merge_scratch_bytes() { return (int)sizeof(MergeScratch); }

// frags [data, out_cap] -> dep_rows [out_cap], dep_ts [out_cap, 3] and the
// checksum word over (indptr [s+1], dep_rows, dep_ts), ONE launch;
// scratch: merge_scratch_bytes() zeroed bytes, left zeroed
extern "C" int fragment_merge(const void* frags, int data, int out_cap,
                              const void* ts, int ts_rows, int s,
                              const void* indptr, void* dep_rows,
                              void* dep_ts, void* csum, void* scratch,
                              void* stream) {
  if (data <= 0 || out_cap < 0 || ts_rows <= 0 || s < 0)
    return (int)cudaErrorInvalidValue;
  const int most = 4 * sm_count();
  int g = grid_for(out_cap, CT * MG_U);
  if (g > most) g = most;
  fragment_merge_kernel<<<g, CT, 0, (cudaStream_t)stream>>>(
      (const int*)frags, data, out_cap, (const int*)ts, ts_rows, s,
      (const int*)indptr, (int*)dep_rows, (int*)dep_ts, (unsigned*)csum,
      (MergeScratch*)scratch);
  ACCORD_CHECK();
  return 0;
}
