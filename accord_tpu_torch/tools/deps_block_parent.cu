// The parent's key body (K1/K13 before the redesign of
// csrc/deps_block.cuh), kept to time it beside the shipped one on the same
// card in the same process: tools/deps_block_variants.py builds this file
// alone and binds its four entries, whose C signatures are the shipped
// ones, in place of the shipped library's. Not built by ops/_ext.py.
//
// One warp per 32-row word keeps its rows' bucket words in registers (lane
// i holds row 32w + i), walks a tile of 64 subjects whose words sit in
// shared memory, tests the cheap row masks first and the AND over all nw
// words where they pass; `__ballot_sync` yields the word, lane 0 stores it.
// A tile with no subject of the block writes its zero words (4-byte stores
// at the output's row stride) after loading the whole subject tile.
#include "common.cuh"

#define MAX_NW 32      // K <= 1024 buckets: a row's words fit in registers
#define SUBJ_TILE 64   // subjects per block (shared-memory tile)
#define WARPS 4        // 32-row words per block

// The block body: blockIdx.x is the group of WARPS row words, blockIdx.y
// the subject tile. Row r's nw bucket words start at act_bm + r * bm_stride
// (bm_stride == nw for a whole arena; a mesh shard reads its 'model' word
// slice of a wider arena in place). subj_store == nullptr: no slot mask (single store);
// else subject s is this block's when subj_store[s] == slot. A tile none
// of whose subjects is this block's writes its zero words and stops.
__device__ __forceinline__ void resolve_body(
    const unsigned* __restrict__ subj_words,
    const int* __restrict__ subj_before, const int* __restrict__ subj_kinds,
    const int* __restrict__ subj_store, int slot,
    const unsigned char* __restrict__ subj_gate, int b,
    const unsigned* __restrict__ act_bm, int bm_stride,
    const int* __restrict__ act_ts, const int* __restrict__ act_kinds,
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
    rw[j] = j < nw ? act_bm[(long long)row * bm_stride + j] : 0u;
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
               const unsigned* __restrict__ act_bm, int bm_stride,
               const int* __restrict__ act_ts,
               const int* __restrict__ act_kinds,
               const unsigned char* __restrict__ act_valid, int cap, int nw,
               const int* __restrict__ witness, int nk,
               unsigned* __restrict__ out, int out_stride, int out_off) {
  resolve_body(subj_words, subj_before, subj_kinds, subj_store,
               slot_ptr == nullptr ? 0 : *slot_ptr, subj_gate, b, act_bm,
               bm_stride, act_ts, act_kinds, act_valid, cap, nw, witness, nk,
               out, out_stride, out_off);
}

extern "C" int deps_block(const void* subj_words, const void* subj_before,
                          const void* subj_kinds, const void* subj_store,
                          const void* slot, int b, const void* act_bm,
                          int bm_stride, const void* act_ts,
                          const void* act_kinds,
                          const void* act_valid, int cap, int nw,
                          const void* witness, int nk, void* out,
                          int out_stride, int out_off, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31) || bm_stride < nw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int words = cap >> 5;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  if (words == 0 || b == 0) return 0;
  resolve_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)subj_words, (const int*)subj_before,
      (const int*)subj_kinds, (const int*)subj_store, (const int*)slot,
      nullptr, b,
      (const unsigned*)act_bm, bm_stride, (const int*)act_ts,
      (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, out_stride, out_off);
  ACCORD_CHECK();
  return 0;
}

struct KeyBlk {              // 48 bytes (csrc/node_resolve.cu)
  const unsigned* bm;
  const int* ts;
  const int* kinds;
  const unsigned char* valid;
  int cap, out_off, pad0, pad1;
};

struct TabHdr {
  unsigned* out;
  long long nblk;
};

struct KeyShard {            // 64 bytes (csrc/node_resolve.cu)
  const unsigned* bm;
  const int* ts;
  const int* kinds;
  const unsigned char* valid;
  const unsigned* sw;
  unsigned* out;
  int cap, out_off;
  int bm_stride, pad;
};

__global__ void __launch_bounds__(WARPS * 32)
node_key_kernel(const unsigned char* __restrict__ tab,
                const unsigned* __restrict__ subj_words,
                const int* __restrict__ subj_before,
                const int* __restrict__ subj_kinds,
                const int* __restrict__ subj_node,
                const int* __restrict__ slots,
                const unsigned char* __restrict__ gate, int b, int nw,
                const int* __restrict__ witness, int nk, int out_stride) {
  const TabHdr* h = (const TabHdr*)tab;
  const KeyBlk bk = ((const KeyBlk*)(tab + sizeof(TabHdr)))[blockIdx.z];
  if ((int)blockIdx.x * WARPS >= (bk.cap >> 5)) return;
  resolve_body(subj_words, subj_before, subj_kinds, subj_node,
               slots[blockIdx.z], gate, b, bk.bm, nw, bk.ts, bk.kinds,
               bk.valid, bk.cap, nw, witness, nk, h->out, out_stride,
               bk.out_off);
}

extern "C" int node_key_resolve(const void* tab, int nblocks, int max_cap,
                                const void* subj_words,
                                const void* subj_before,
                                const void* subj_kinds, const void* subj_node,
                                const void* slots, const void* gate, int b,
                                int nw, const void* witness, int nk,
                                int out_stride, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (max_cap & 31))
    return (int)cudaErrorInvalidValue;
  if (nblocks <= 0 || b <= 0 || max_cap <= 0) return 0;
  if (nblocks > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = max_cap >> 5;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE,
            nblocks);
  node_key_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned char*)tab, (const unsigned*)subj_words,
      (const int*)subj_before, (const int*)subj_kinds, (const int*)subj_node,
      (const int*)slots, (const unsigned char*)gate, b, nw,
      (const int*)witness, nk, out_stride);
  ACCORD_CHECK();
  return 0;
}

__global__ void __launch_bounds__(WARPS * 32)
node_key_shard_kernel(const KeyShard* __restrict__ tab,
                      const int* __restrict__ subj_before,
                      const int* __restrict__ subj_kinds,
                      const int* __restrict__ subj_node,
                      const int* __restrict__ slots,
                      const unsigned char* __restrict__ gate, int b, int nwl,
                      const int* __restrict__ witness, int nk,
                      int out_stride) {
  const KeyShard e = tab[blockIdx.z];
  if ((int)blockIdx.x * WARPS >= (e.cap >> 5)) return;
  resolve_body(e.sw, subj_before, subj_kinds, subj_node, slots[blockIdx.z],
               gate, b, e.bm, e.bm_stride, e.ts, e.kinds, e.valid, e.cap,
               nwl, witness, nk, e.out, out_stride, e.out_off);
}

extern "C" int node_key_shard(const void* tab, int nent, int max_cap,
                              const void* subj_before, const void* subj_kinds,
                              const void* subj_node, const void* slots,
                              const void* gate, int b, int nwl,
                              const void* witness, int nk, int out_stride,
                              void* stream) {
  if (nwl > MAX_NW || nk * nk > 64 || (max_cap & 31))
    return (int)cudaErrorInvalidValue;
  if (nent <= 0 || b <= 0 || max_cap <= 0) return 0;
  if (nent > 65535) return (int)cudaErrorInvalidValue;
  const int words = max_cap >> 5;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE,
            nent);
  node_key_shard_kernel<<<grid, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const KeyShard*)tab, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_node, (const int*)slots, (const unsigned char*)gate,
      b, nwl, (const int*)witness, nk, out_stride);
  ACCORD_CHECK();
  return 0;
}

extern "C" int range_key_block(const void* cov, const void* subj_before,
                               const void* subj_kinds,
                               const void* subj_is_range,
                               const void* subj_store, const void* slot,
                               int b, const void* act_bm, int bm_stride,
                               const void* act_ts, const void* act_kinds,
                               const void* act_valid, int cap, int nw,
                               const void* witness, int nk, void* out,
                               int stride, int off, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31) || bm_stride < nw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int words = cap >> 5;
  if (words == 0 || b == 0) return 0;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  resolve_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)cov, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_store, (const int*)slot,
      (const unsigned char*)subj_is_range, b, (const unsigned*)act_bm,
      bm_stride, (const int*)act_ts, (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, stride, off);
  ACCORD_CHECK();
  return 0;
}
