// K3: dirty-row scatter into a store's key arena.
//
// Replaces accord_tpu/ops/kernels.py `arena_scatter` (:822) and
// `arena_scatter_keys` (:840). Each dirty row's bucket bitmap is rebuilt
// from the CSR (row, bucket) list: clear the row, then set its buckets, so
// a row whose key set shrank loses its stale bits. The full variant also
// writes the rows' ts / exec_ts / kinds / valid lanes.
//
// Functional, like the JAX kernel: the result is a freshly allocated copy
// (a staged plan may still hold the old arena as its snapshot), so the
// first launch copies the packed bitmap (cap * K/32 words; 2 MB at cap
// 16384, K 1024) and, for the full variant, the row lanes. What bounds it
// is that copy: bytes, read once and written once. The scatter itself
// touches at most 64 rows and 1024 CSR entries. Launch order on one
// stream gives the contract: copy, then clear the dirty rows and write
// their lanes (duplicate padding rows carry identical data, so racing
// writes agree), then a separate launch sets the CSR bits with atomicOr
// (pad entries use row == cap and are dropped), so no block's clear can
// race another block's set.
#include "common.cuh"

__global__ void clear_rows_kernel(unsigned* __restrict__ bm, int cap, int nw,
                                  const int* __restrict__ rows, int lanes,
                                  int* __restrict__ ts, int* __restrict__ ex,
                                  int* __restrict__ kinds,
                                  unsigned char* __restrict__ valid,
                                  const int* __restrict__ ts_rows,
                                  const int* __restrict__ ex_rows,
                                  const int* __restrict__ kind_rows,
                                  const unsigned char* __restrict__ valid_rows) {
  const int i = blockIdx.x;  // one block per dirty-row entry
  const int r = norm_index(rows[i], cap);
  if (r < 0) return;
  for (int j = threadIdx.x; j < nw; j += blockDim.x)
    bm[(long long)r * nw + j] = 0u;
  if (lanes && threadIdx.x == 0) {
    ts[r * 3] = ts_rows[i * 3];
    ts[r * 3 + 1] = ts_rows[i * 3 + 1];
    ts[r * 3 + 2] = ts_rows[i * 3 + 2];
    ex[r * 3] = ex_rows[i * 3];
    ex[r * 3 + 1] = ex_rows[i * 3 + 1];
    ex[r * 3 + 2] = ex_rows[i * 3 + 2];
    kinds[r] = kind_rows[i];
    valid[r] = valid_rows[i];
  }
}

__global__ void set_bits_kernel(unsigned* __restrict__ bm, int cap, int k,
                                int nw, const int* __restrict__ key_rows,
                                const int* __restrict__ key_mods, int z) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= z) return;
  int r = norm_index(key_rows[e], cap);
  int key = norm_index(key_mods[e], k);
  if (r < 0 || key < 0) return;
  atomicOr(&bm[(long long)r * nw + (key >> 5)], 1u << (key & 31));
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
  cudaStream_t st = (cudaStream_t)stream;
  launch_copy<unsigned>((unsigned*)bm_out, (const unsigned*)bm_in,
                        (long long)cap * nw, st);
  ACCORD_CHECK();
  if (lanes) {
    launch_copy<int>((int*)ts_out, (const int*)ts_in, (long long)cap * 3, st);
    launch_copy<int>((int*)ex_out, (const int*)ex_in, (long long)cap * 3, st);
    launch_copy<int>((int*)kinds_out, (const int*)kinds_in, cap, st);
    launch_copy<unsigned char>((unsigned char*)valid_out,
                               (const unsigned char*)valid_in, cap, st);
    ACCORD_CHECK();
  }
  if (m > 0) {
    clear_rows_kernel<<<m, 128, 0, st>>>(
        (unsigned*)bm_out, cap, nw, (const int*)rows, lanes, (int*)ts_out,
        (int*)ex_out, (int*)kinds_out, (unsigned char*)valid_out,
        (const int*)ts_rows, (const int*)ex_rows, (const int*)kind_rows,
        (const unsigned char*)valid_rows);
    ACCORD_CHECK();
  }
  if (z > 0) {
    set_bits_kernel<<<(z + 255) / 256, 256, 0, st>>>(
        (unsigned*)bm_out, cap, nw * 32, nw, (const int*)key_rows,
        (const int*)key_mods, z);
    ACCORD_CHECK();
  }
  return 0;
}
