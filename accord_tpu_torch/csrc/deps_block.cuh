// K1's block kernel, shared with K5's key side (range_resolve.cu) and
// K13/K14 (node_resolve.cu, through resolve_body): one packed dependency
// word per (subject, 32 arena rows) of one store block.
// One warp per 32-row word keeps its rows' bucket words in registers (lane
// i holds row 32w + i), walks a tile of subjects whose words sit in shared
// memory (a broadcast read), tests the cheap row masks first (valid, store
// slot and gate, witness table, lexicographic before) and the bucket AND
// only where they pass; `__ballot_sync` yields the packed word itself.
#pragma once

#include "common.cuh"

#define MAX_NW 32      // K <= 1024 buckets: a row's words fit in registers
#define SUBJ_TILE 64   // subjects per block (shared-memory tile)
#define WARPS 4        // 32-row words per block

// The block body: blockIdx.x is the group of WARPS row words, blockIdx.y
// the subject tile. subj_store == nullptr: no slot mask (single store);
// else subject s is this block's when subj_store[s] == slot. A tile none
// of whose subjects is this block's writes its zero words and stops.
__device__ __forceinline__ void resolve_body(
    const unsigned* __restrict__ subj_words,
    const int* __restrict__ subj_before, const int* __restrict__ subj_kinds,
    const int* __restrict__ subj_store, int slot,
    const unsigned char* __restrict__ subj_gate, int b,
    const unsigned* __restrict__ act_bm, const int* __restrict__ act_ts,
    const int* __restrict__ act_kinds,
    const unsigned char* __restrict__ act_valid, int cap, int nw,
    const int* __restrict__ witness, int nk, unsigned* __restrict__ out,
    int out_stride, int out_off) {
  __shared__ unsigned s_subj[SUBJ_TILE * MAX_NW];
  __shared__ int s_before[SUBJ_TILE * 3];
  __shared__ int s_kind[SUBJ_TILE];
  __shared__ int s_mine[SUBJ_TILE];
  __shared__ int s_wit[64];
  const int tid = threadIdx.x;
  const int s0 = blockIdx.y * SUBJ_TILE;
  const int ns = min(SUBJ_TILE, b - s0);
  for (int i = tid; i < ns * nw; i += blockDim.x) {
    int s = i / nw, j = i - s * nw;
    s_subj[s * MAX_NW + j] = subj_words[(long long)(s0 + s) * nw + j];
  }
  for (int i = tid; i < ns * 3; i += blockDim.x)
    s_before[i] = subj_before[(long long)s0 * 3 + i];
  int mine_any = 0;
  for (int i = tid; i < ns; i += blockDim.x) {
    int kd = subj_kinds[s0 + i];
    if (kd < 0) kd += nk;                 // a jnp gather: wrap, then clamp
    s_kind[i] = min(max(kd, 0), nk - 1);
    s_mine[i] = (subj_store == nullptr ? 1 : (subj_store[s0 + i] == slot)) &&
                (subj_gate == nullptr || subj_gate[s0 + i] != 0);
    mine_any |= s_mine[i];
  }
  for (int i = tid; i < nk * nk; i += blockDim.x) s_wit[i] = witness[i];
  mine_any = __syncthreads_or(mine_any);

  const int lane = tid & 31;
  const int w = blockIdx.x * WARPS + (tid >> 5);
  if (w >= (cap >> 5)) return;  // no barrier below this point
  if (!mine_any) {
    for (int s = lane; s < ns; s += 32)
      out[out_off + w + (long long)(s0 + s) * out_stride] = 0u;
    return;
  }
  const int row = (w << 5) + lane;
  unsigned rw[MAX_NW];
#pragma unroll
  for (int j = 0; j < MAX_NW; ++j)
    rw[j] = j < nw ? act_bm[(long long)row * nw + j] : 0u;
  const int t0 = act_ts[row * 3], t1 = act_ts[row * 3 + 1],
            t2 = act_ts[row * 3 + 2];
  int ak = act_kinds[row];
  if (ak < 0) ak += nk;
  ak = min(max(ak, 0), nk - 1);
  const bool valid = act_valid[row] != 0;
  unsigned* dst = out + out_off + w;
  for (int s = 0; s < ns; ++s) {
    bool hit = valid && s_mine[s] && s_wit[s_kind[s] * nk + ak] == 1 &&
               lex_before(t0, t1, t2, s_before[s * 3], s_before[s * 3 + 1],
                          s_before[s * 3 + 2]);
    if (hit) {
      const unsigned* sw = s_subj + s * MAX_NW;
      unsigned acc = 0;
#pragma unroll
      for (int j = 0; j < MAX_NW; ++j)
        if (j < nw) acc |= rw[j] & sw[j];
      hit = acc != 0;
    }
    unsigned word = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) dst[(long long)(s0 + s) * out_stride] = word;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
resolve_kernel(const unsigned* __restrict__ subj_words,
               const int* __restrict__ subj_before,
               const int* __restrict__ subj_kinds,
               const int* __restrict__ subj_store,
               const int* __restrict__ slot_ptr,
               const unsigned char* __restrict__ subj_gate, int b,
               const unsigned* __restrict__ act_bm,
               const int* __restrict__ act_ts,
               const int* __restrict__ act_kinds,
               const unsigned char* __restrict__ act_valid, int cap, int nw,
               const int* __restrict__ witness, int nk,
               unsigned* __restrict__ out, int out_stride, int out_off) {
  resolve_body(subj_words, subj_before, subj_kinds, subj_store,
               slot_ptr == nullptr ? 0 : *slot_ptr, subj_gate, b, act_bm,
               act_ts, act_kinds, act_valid, cap, nw, witness, nk, out,
               out_stride, out_off);
}
