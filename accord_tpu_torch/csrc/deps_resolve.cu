// K1: the key-domain deps query, one packed dependency word per
// (subject, 32 arena rows).
//
// Replaces accord_tpu/ops/kernels.py `deps_resolve` (:268) and, with one
// launch per store block writing its own word span, `fused_deps_resolve`
// (:305). The JAX kernel builds f32 subject bitmaps [B, K] and tests
// overlap as a bf16 matmul against the arena's f32 [cap, K] bitmaps (> 0.5).
// Here the arena bitmaps stay PACKED, as [cap, K/32] words: overlap is
// exactly `any(subject_words & row_words)`, which is what the 0/1 product
// counted, and at cap 16384, K 1024 the lane is 2 MB instead of 64 MB.
//
// What bounds it on an H100: the work is B * cap * K/32 word ANDs on the
// CUDA cores (1024 * 16384 * 32 = 537M at the PreAccept-batch shape); the
// bytes (the 2 MB packed lane plus the small row lanes) are read once per
// subject tile and mostly come from L2. The design: a pre-pass turns the
// subject CSR into packed subject words with atomicOr; then one warp per
// 32-row word keeps its 32 rows' words in registers (lane i holds row
// 32w + i), walks a tile of subjects whose words sit in shared memory
// (every lane reads the same address: a broadcast), tests the cheap row
// masks first (valid, store slot, witness table, lexicographic before) and
// the bucket AND only where they pass, and `__ballot_sync` yields the
// packed word itself. The bitwise AND-popcount tensor-core path
// (mma .b1) is a later change.
#include "common.cuh"

#define MAX_NW 32      // K <= 1024 buckets: a row's words fit in registers
#define SUBJ_TILE 64   // subjects per block (shared-memory tile)
#define WARPS 4        // 32-row words per block

__global__ void subject_bitmap_kernel(const int* __restrict__ subj_of,
                                      const int* __restrict__ subj_keys,
                                      int nnz, int b, int k, int nw,
                                      unsigned* __restrict__ subj_words) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= nnz) return;
  int s = norm_index(subj_of[i], b);
  int key = norm_index(subj_keys[i], k);
  if (s < 0 || key < 0) return;  // CSR padding (subj_of == B) is dropped
  atomicOr(&subj_words[(long long)s * nw + (key >> 5)], 1u << (key & 31));
}

__global__ void __launch_bounds__(WARPS * 32)
resolve_kernel(const unsigned* __restrict__ subj_words,
               const int* __restrict__ subj_before,
               const int* __restrict__ subj_kinds,
               const int* __restrict__ subj_store,
               const int* __restrict__ slot_ptr, int b,
               const unsigned* __restrict__ act_bm,
               const int* __restrict__ act_ts,
               const int* __restrict__ act_kinds,
               const unsigned char* __restrict__ act_valid, int cap, int nw,
               const int* __restrict__ witness, int nk,
               unsigned* __restrict__ out, int out_stride, int out_off) {
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
  const int slot = slot_ptr == nullptr ? 0 : *slot_ptr;
  for (int i = tid; i < ns; i += blockDim.x) {
    int kd = subj_kinds[s0 + i];
    if (kd < 0) kd += nk;                 // a jnp gather: wrap, then clamp
    s_kind[i] = min(max(kd, 0), nk - 1);
    s_mine[i] = subj_store == nullptr ? 1 : (subj_store[s0 + i] == slot);
  }
  for (int i = tid; i < nk * nk; i += blockDim.x) s_wit[i] = witness[i];
  __syncthreads();

  const int lane = tid & 31;
  const int w = blockIdx.x * WARPS + (tid >> 5);
  if (w >= (cap >> 5)) return;  // no barrier below this point
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

// Packed subject words [b, k/32] from the subject CSR (zeroed first).
extern "C" int deps_subjects(const void* subj_of, const void* subj_keys,
                             int nnz, int b, int k, void* subj_words,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int nw = k >> 5;
  cudaMemsetAsync(subj_words, 0, (size_t)b * nw * sizeof(unsigned), st);
  ACCORD_CHECK();
  if (nnz > 0) {
    subject_bitmap_kernel<<<(nnz + 255) / 256, 256, 0, st>>>(
        (const int*)subj_of, (const int*)subj_keys, nnz, b, k, nw,
        (unsigned*)subj_words);
    ACCORD_CHECK();
  }
  return 0;
}

// One arena block: out[s, out_off + w] for every subject s and row word w.
// subj_store == slot == NULL for the single-store kernel (no slot mask);
// fused, `slot` points at this block's entry of the slots lane.
extern "C" int deps_block(const void* subj_words, const void* subj_before,
                          const void* subj_kinds, const void* subj_store,
                          const void* slot, int b, const void* act_bm,
                          const void* act_ts, const void* act_kinds,
                          const void* act_valid, int cap, int nw,
                          const void* witness, int nk, void* out,
                          int out_stride, int out_off, void* stream) {
  if (nw > MAX_NW || nk * nk > 64 || (cap & 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int words = cap >> 5;
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  if (words == 0 || b == 0) return 0;
  resolve_kernel<<<grid, WARPS * 32, 0, st>>>(
      (const unsigned*)subj_words, (const int*)subj_before,
      (const int*)subj_kinds, (const int*)subj_store, (const int*)slot, b,
      (const unsigned*)act_bm, (const int*)act_ts, (const int*)act_kinds,
      (const unsigned char*)act_valid, cap, nw, (const int*)witness, nk,
      (unsigned*)out, out_stride, out_off);
  ACCORD_CHECK();
  return 0;
}
