// K5's range-side passes, shared with K14 (node_resolve.cu): the covered
// buckets of an interval CSR, the overlap bits of one range block OR-ed
// per subject, and the row masks over them (K1's subject-tile layout).
#pragma once

#include "deps_block.cuh"

// one warp per (interval e, 32-bucket word wd): covered bits OR-ed into
// cov[o, wd] (cov zeroed by the caller)
__global__ void covered_kernel(const int* __restrict__ iv_of,
                               const int* __restrict__ iv_s,
                               const int* __restrict__ iv_e, int nv, int b,
                               int k, unsigned* __restrict__ cov) {
  const int nw = k >> 5;
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (g >= (long long)nv * nw) return;  // uniform per warp
  const int e = (int)(g / nw);
  const int wd = (int)(g - (long long)e * nw);
  const int o = norm_index(iv_of[e], b);
  if (o < 0) return;                     // uniform per warp
  const unsigned s = (unsigned)iv_s[e];
  const int width = (int)((unsigned)iv_e[e] - s);  // wrapping int32
  const bool wide = width <= 0 || width >= k;
  const unsigned j = (unsigned)((wd << 5) + lane);
  const bool covered = wide || ((j - s) & (unsigned)(k - 1)) < (unsigned)width;
  const unsigned word = __ballot_sync(0xffffffffu, covered);
  if (lane == 0 && word) atomicOr(&cov[(long long)o * nw + wd], word);
}

// one warp per (interval e, 32-row word wd) of one range block: overlap
// bits OR-ed into anyr[o, off + wd] (that span zeroed by the caller)
__device__ __forceinline__ void range_any_body(
    long long g, int lane, const int* __restrict__ iv_of,
    const int* __restrict__ iv_s, const int* __restrict__ iv_e, int nv, int b,
    const int* __restrict__ r_start, const int* __restrict__ r_end, int rcap,
    unsigned* __restrict__ anyr, int stride, int off) {
  const int words = rcap >> 5;
  if (g >= (long long)nv * words) return;
  const int e = (int)(g / words);
  const int wd = (int)(g - (long long)e * words);
  const int o = norm_index(iv_of[e], b);
  if (o < 0) return;
  const int row = (wd << 5) + lane;
  const bool hit = iv_s[e] < r_end[row] && r_start[row] < iv_e[e];
  const unsigned word = __ballot_sync(0xffffffffu, hit);
  if (lane == 0 && word) atomicOr(&anyr[(long long)o * stride + off + wd], word);
}

__global__ void range_any_kernel(const int* __restrict__ iv_of,
                                 const int* __restrict__ iv_s,
                                 const int* __restrict__ iv_e, int nv, int b,
                                 const int* __restrict__ r_start,
                                 const int* __restrict__ r_end, int rcap,
                                 unsigned* __restrict__ anyr, int stride,
                                 int off) {
  range_any_body(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                 threadIdx.x & 31, iv_of, iv_s, iv_e, nv, b, r_start, r_end,
                 rcap, anyr, stride, off);
}

// pass 2, range side: out[s, off + w] = anyr[s, off + w] & the row masks
// (a tile none of whose subjects is this block's writes its zero words)
__device__ __forceinline__ void range_mask_body(
    const unsigned* __restrict__ anyr, const int* __restrict__ subj_before,
    const int* __restrict__ subj_kinds, const int* __restrict__ subj_store,
    int slot, int b, const int* __restrict__ r_ts,
    const int* __restrict__ r_kinds, const unsigned char* __restrict__ r_valid,
    int rcap, const int* __restrict__ witness, int nk,
    unsigned* __restrict__ out, int stride, int off) {
  __shared__ int s_before[SUBJ_TILE * 3];
  __shared__ int s_kind[SUBJ_TILE];
  __shared__ int s_mine[SUBJ_TILE];
  __shared__ int s_wit[64];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * SUBJ_TILE;
  const int ns = min(SUBJ_TILE, b - s0);
  for (int i = tid; i < ns * 3; i += blockDim.x)
    s_before[i] = subj_before[(long long)s0 * 3 + i];
  int mine_any = 0;
  for (int i = tid; i < ns; i += blockDim.x) {
    int kd = subj_kinds[s0 + i];
    if (kd < 0) kd += nk;                 // a jnp gather: wrap, then clamp
    s_kind[i] = min(max(kd, 0), nk - 1);
    s_mine[i] = subj_store == nullptr ? 1 : (subj_store[s0 + i] == slot);
    mine_any |= s_mine[i];
  }
  for (int i = tid; i < nk * nk; i += blockDim.x) s_wit[i] = witness[i];
  mine_any = __syncthreads_or(mine_any);

  const int lane = tid & 31;
  const int w = blockIdx.x * WARPS + (tid >> 5);
  if (w >= (rcap >> 5)) return;  // no barrier below this point
  if (!mine_any) {
    for (int s = lane; s < ns; s += 32)
      out[(long long)(s0 + s) * stride + off + w] = 0u;
    return;
  }
  const int row = (w << 5) + lane;
  const int t0 = r_ts[row * 3], t1 = r_ts[row * 3 + 1], t2 = r_ts[row * 3 + 2];
  int rk = r_kinds[row];
  if (rk < 0) rk += nk;
  rk = min(max(rk, 0), nk - 1);
  const bool valid = r_valid[row] != 0;
  for (int s = 0; s < ns; ++s) {
    const long long at = (long long)(s0 + s) * stride + off + w;
    const bool hit = valid && s_mine[s] && ((anyr[at] >> lane) & 1u) &&
                     s_wit[s_kind[s] * nk + rk] == 1 &&
                     lex_before(t0, t1, t2, s_before[s * 3],
                                s_before[s * 3 + 1], s_before[s * 3 + 2]);
    const unsigned word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) out[at] = word;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
range_mask_kernel(const unsigned* __restrict__ anyr,
                  const int* __restrict__ subj_before,
                  const int* __restrict__ subj_kinds,
                  const int* __restrict__ subj_store,
                  const int* __restrict__ slot_ptr, int b,
                  const int* __restrict__ r_ts,
                  const int* __restrict__ r_kinds,
                  const unsigned char* __restrict__ r_valid, int rcap,
                  const int* __restrict__ witness, int nk,
                  unsigned* __restrict__ out, int stride, int off) {
  range_mask_body(anyr, subj_before, subj_kinds, subj_store,
                  slot_ptr == nullptr ? 0 : *slot_ptr, b, r_ts, r_kinds,
                  r_valid, rcap, witness, nk, out, stride, off);
}
