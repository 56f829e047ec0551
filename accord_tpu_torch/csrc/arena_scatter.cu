// K3: dirty-row scatter into a store's key arena, ONE launch a call.
//
// Replaces accord_tpu/ops/kernels.py `arena_scatter` (:822) and
// `arena_scatter_keys` (:840). Each dirty row's bucket bitmap is rebuilt
// from the CSR (row, bucket) list: clear the row, then set its buckets, so
// a row whose key set shrank loses its stale bits; a CSR entry whose row is
// not dirty still sets its bit in the copied row (clear, then max). The
// full variant also writes the rows' ts / exec_ts / kinds / valid lanes.
// Padding: a CSR entry with row == cap is dropped, a negative row or key
// counts from the end once (norm_index), and duplicate padding rows carry
// identical data, so whichever entry a row keeps is the same.
//
// Functional, like the JAX kernel: the result is a fresh copy (a staged
// plan may still hold the old arena as its snapshot). The design,
// owner-CTA rebuild-or-copy: each CTA owns a span of output rows. It reads
// the dirty-row list (at most a tier of 64) and keeps, per row of its span,
// the entry that names it; it walks the CSR list (at most 1,024 entries)
// and ORs the bits of its span's rows into a shared [span x nw] tile; then
// it writes each of its rows once as 16-byte vectors -- a dirty row is its
// shared bits, any other row the input row OR its shared bits -- and its
// span of the row lanes, a dirty row's from the caller's rows. One CTA
// owns every output row, so nothing races and no atomics touch global
// memory. What bounds it: bytes, the packed bitmap (cap * K/32 words; 2 MB
// at cap 16384, K 1024) and the lanes read once and written once; at a
// burn's cap, the launch.
#include "common.cuh"

#define AS_THREADS 256
#define AS_SPAN 64                // output rows a CTA owns at most
#define AS_SMEM (48 * 1024)       // the shared tile's bytes at most

struct ScatterArgs {
  unsigned* bm_out;
  const unsigned* bm_in;
  int* ts_out;
  const int* ts_in;
  int* ex_out;
  const int* ex_in;
  int* kinds_out;
  const int* kinds_in;
  unsigned char* valid_out;
  const unsigned char* valid_in;
  const int* rows;
  const int* key_rows;
  const int* key_mods;
  const int* ts_rows;
  const int* ex_rows;
  const int* kind_rows;
  const unsigned char* valid_rows;
  int cap, nw, m, z, lanes, span, vec;
};

__global__ void __launch_bounds__(AS_THREADS)
arena_scatter_kernel(const __grid_constant__ ScatterArgs a) {
  extern __shared__ unsigned s_bits[];     // [span][nw]
  __shared__ int s_dirty[AS_SPAN];         // the rows entry naming it, or -1
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * a.span;
  const int nr = min(a.span, a.cap - r0);
  const int nw = a.nw;
  for (int i = tid; i < nr; i += AS_THREADS) s_dirty[i] = -1;
  for (int i = tid; i < nr * nw; i += AS_THREADS) s_bits[i] = 0u;
  __syncthreads();
  for (int i = tid; i < a.m; i += AS_THREADS) {
    const int r = norm_index(a.rows[i], a.cap);
    if (r >= r0 && r < r0 + nr) s_dirty[r - r0] = i;
  }
  const int k = nw << 5;
  for (int e = tid; e < a.z; e += AS_THREADS) {
    const int r = norm_index(a.key_rows[e], a.cap);
    if (r < r0 || r >= r0 + nr) continue;
    const int key = norm_index(a.key_mods[e], k);
    if (key < 0) continue;
    atomicOr(&s_bits[(r - r0) * nw + (key >> 5)], 1u << (key & 31));
  }
  __syncthreads();
  // the bitmap rows: a dirty row's bits, else the input row | its bits
  const long long base = (long long)r0 * nw;
  if (a.vec) {                             // nw % 4 == 0, 16-byte aligned
    const int q = nw >> 2;
    const uint4* src = reinterpret_cast<const uint4*>(a.bm_in + base);
    uint4* dst = reinterpret_cast<uint4*>(a.bm_out + base);
    for (int i = tid; i < nr * q; i += AS_THREADS) {
      const int row = i / q;
      const unsigned* b = s_bits + (i << 2);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s_dirty[row] < 0) v = src[i];
      v.x |= b[0];
      v.y |= b[1];
      v.z |= b[2];
      v.w |= b[3];
      dst[i] = v;
    }
  } else {
    for (int i = tid; i < nr * nw; i += AS_THREADS) {
      const unsigned v = s_dirty[i / nw] < 0 ? a.bm_in[base + i] : 0u;
      a.bm_out[base + i] = v | s_bits[i];
    }
  }
  if (!a.lanes) return;
  for (int i = tid; i < nr * 3; i += AS_THREADS) {
    const int d = s_dirty[i / 3];
    const long long o = (long long)r0 * 3 + i;
    const int c = i % 3;
    a.ts_out[o] = d < 0 ? a.ts_in[o] : a.ts_rows[d * 3 + c];
    a.ex_out[o] = d < 0 ? a.ex_in[o] : a.ex_rows[d * 3 + c];
  }
  for (int i = tid; i < nr; i += AS_THREADS) {
    const int d = s_dirty[i];
    a.kinds_out[r0 + i] = d < 0 ? a.kinds_in[r0 + i] : a.kind_rows[d];
    a.valid_out[r0 + i] = d < 0 ? a.valid_in[r0 + i] : a.valid_rows[d];
  }
}

// lanes == 0: the keys-only variant (ts .. valid pointers unused, may be 0)
extern "C" int arena_scatter(void* bm_out, const void* bm_in, int cap, int nw,
                             void* ts_out, const void* ts_in, void* ex_out,
                             const void* ex_in, void* kinds_out,
                             const void* kinds_in, void* valid_out,
                             const void* valid_in, const void* rows, int m,
                             const void* key_rows, const void* key_mods,
                             int z, const void* ts_rows, const void* ex_rows,
                             const void* kind_rows, const void* valid_rows,
                             int lanes, void* stream) {
  if (cap < 0 || nw <= 0 || m < 0 || z < 0 || (long long)nw * 4 > AS_SMEM)
    return (int)cudaErrorInvalidValue;
  if (cap == 0) return 0;
  ScatterArgs a;
  a.bm_out = (unsigned*)bm_out;
  a.bm_in = (const unsigned*)bm_in;
  a.ts_out = (int*)ts_out;
  a.ts_in = (const int*)ts_in;
  a.ex_out = (int*)ex_out;
  a.ex_in = (const int*)ex_in;
  a.kinds_out = (int*)kinds_out;
  a.kinds_in = (const int*)kinds_in;
  a.valid_out = (unsigned char*)valid_out;
  a.valid_in = (const unsigned char*)valid_in;
  a.rows = (const int*)rows;
  a.key_rows = (const int*)key_rows;
  a.key_mods = (const int*)key_mods;
  a.ts_rows = (const int*)ts_rows;
  a.ex_rows = (const int*)ex_rows;
  a.kind_rows = (const int*)kind_rows;
  a.valid_rows = (const unsigned char*)valid_rows;
  a.cap = cap;
  a.nw = nw;
  a.m = m;
  a.z = z;
  a.lanes = lanes;
  a.vec = (nw & 3) == 0 && ((uintptr_t)bm_out & 15) == 0 &&
          ((uintptr_t)bm_in & 15) == 0;
  // a span of AS_SPAN rows, halved (to 16) while the grid is under an SM
  // a CTA, and while the shared tile would pass AS_SMEM
  int span = AS_SPAN;
  while (span > 16 && (cap + span - 1) / span < sm_count()) span >>= 1;
  while (span > 1 && (long long)span * nw * 4 > AS_SMEM) span >>= 1;
  a.span = span;
  const int grid = (cap + span - 1) / span;
  arena_scatter_kernel<<<grid, AS_THREADS, (size_t)span * nw * 4,
                         (cudaStream_t)stream>>>(a);
  ACCORD_CHECK();
  return 0;
}
