// K8: the exec plane's dirty-row scatter into its wait-graph arena.
//
// Replaces accord_tpu/ops/kernels.py `exec_scatter` (:224). The arena has
// five lanes: the dep adjacency, PACKED int32 [cap, cap/32] (row d of a
// waiter's set in bit d & 31 of word d >> 5, the host shadow's own layout,
// where the JAX kernel unpacks each uploaded row into a bool [cap, cap]
// matrix), exec_ts i32 [cap, 3], and the applied / pending / awaits_all
// bool [cap] flags. Functional like K3/K4: the outputs are fresh lanes,
// because an in-flight frontier still reads the snapshot it was launched
// on. One launch copies all five lanes (common.cuh's multi_copy, 16-byte
// vectors), then one thread per (dirty row, column) writes the row's
// adjacency words, exec_ts lanes and flags.
// Indices follow jnp's `.at[].set` (norm_index): a negative index wraps
// once and one still out of range is dropped. Padding repeats the chunk's
// first row, so duplicate indices carry identical data.
//
// What bounds it: bytes, the whole-lane copy (cap^2/8 + 15 cap read and
// written: 2 x 32 MB of adjacency at cap 16384); the m <= 64 dirty rows
// are noise beside it. An in-place update with copy-on-write is a later
// change.
#include "common.cuh"

// one thread per (dirty row i, column c): c < words is an adjacency word,
// then the three exec_ts lanes, then applied, pending, awaits_all
__global__ void exec_scatter_kernel(
    unsigned* __restrict__ adj, int* __restrict__ ts,
    unsigned char* __restrict__ app, unsigned char* __restrict__ pend,
    unsigned char* __restrict__ aw, int cap, int words,
    const int* __restrict__ idx, int m, const unsigned* __restrict__ r_adj,
    const int* __restrict__ r_ts, const unsigned char* __restrict__ r_app,
    const unsigned char* __restrict__ r_pend,
    const unsigned char* __restrict__ r_aw) {
  const int cols = words + 6;
  const long long n = (long long)m * cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    const int i = (int)(t / cols);
    const int c = (int)(t - (long long)i * cols);
    const int r = norm_index(idx[i], cap);
    if (r < 0) continue;
    if (c < words) {
      adj[(long long)r * words + c] = r_adj[(long long)i * words + c];
    } else if (c < words + 3) {
      const int k = c - words;
      ts[r * 3 + k] = r_ts[i * 3 + k];
    } else if (c == words + 3) {
      app[r] = r_app[i];
    } else if (c == words + 4) {
      pend[r] = r_pend[i];
    } else {
      aw[r] = r_aw[i];
    }
  }
}

// fresh lanes (d_*) = the arena (s_*) with rows idx[i] set from the row data
extern "C" int exec_scatter(void* d_adj, void* d_ts, void* d_app,
                            void* d_pend, void* d_aw, const void* s_adj,
                            const void* s_ts, const void* s_app,
                            const void* s_pend, const void* s_aw, int cap,
                            int words, const void* idx, int m,
                            const void* r_adj, const void* r_ts,
                            const void* r_app, const void* r_pend,
                            const void* r_aw, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  void* dst[5] = {d_adj, d_ts, d_app, d_pend, d_aw};
  const void* src[5] = {s_adj, s_ts, s_app, s_pend, s_aw};
  const long long bytes[5] = {(long long)cap * words * 4, 12LL * cap, cap,
                              cap, cap};
  CopyTable t;
  for (int k = 0; k < 5; ++k) {
    t.src[k] = (const unsigned char*)src[k];
    t.dst[k] = (unsigned char*)dst[k];
    t.bytes[k] = bytes[k];
  }
  t.n = 5;
  int rc = launch_multi_copy(t, st);
  if (rc != 0) return rc;
  const long long n = (long long)m * (words + 6);
  if (n > 0) {
    exec_scatter_kernel<<<grid_for(n, 256), 256, 0, st>>>(
        (unsigned*)d_adj, (int*)d_ts, (unsigned char*)d_app,
        (unsigned char*)d_pend, (unsigned char*)d_aw, cap, words,
        (const int*)idx, m, (const unsigned*)r_adj, (const int*)r_ts,
        (const unsigned char*)r_app, (const unsigned char*)r_pend,
        (const unsigned char*)r_aw);
    ACCORD_CHECK();
  }
  return 0;
}
