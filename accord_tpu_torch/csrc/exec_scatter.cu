// K8: the exec plane's dirty-row scatter into its wait-graph arena, ONE
// launch a call.
//
// Replaces accord_tpu/ops/kernels.py `exec_scatter` (:224). The arena has
// five lanes: the dep adjacency, PACKED int32 [cap, cap/32] (row d of a
// waiter's set in bit d & 31 of word d >> 5, the host shadow's own layout,
// where the JAX kernel unpacks each uploaded row into a bool [cap, cap]
// matrix), exec_ts i32 [cap, 3], and the applied / pending / awaits_all
// bool [cap] flags. Functional like K3/K4: the outputs are fresh lanes,
// because an in-flight frontier still reads the snapshot it was launched
// on. Indices follow jnp's `.at[].set` (norm_index): a negative index wraps
// once and one still out of range is dropped. Padding repeats the chunk's
// first row, so duplicate indices carry identical data and whichever entry
// a row keeps is the same.
//
// The design, owner-CTA copy-or-scatter (K3's form): each CTA owns a span
// of ES_SPAN output rows across all five lanes. Since cap % 32 == 0 every
// span is whole and each lane's slice of it is a whole number of 16-byte
// vectors at a 16-byte aligned offset (ES_SPAN rows x 4 W bytes, x 12
// bytes, x 1 byte). A thread issues its first ES_U vectors' loads of the
// old lanes at once, then the CTA maps its rows to their source entry
// (-1: none) from the call's m indices in shared memory; a CTA with no
// dirty row stores what it loaded, one with a dirty row first takes each
// element of a dirty row from the row data. Every output byte is written
// once; there is no whole-lane copy before it and no second kernel.
//
// What bounds it: bytes, the five lanes read once and written once
// (cap^2/8 + 15 cap each way: 2 x 32 MB of adjacency at cap 16384); the m
// dirty rows are noise beside it. At the exec burns' cap (1024, 143 KB)
// it is one launch. An in-place update with copy-on-write is a later
// change.
#include "common.cuh"

#define ES_THREADS 256
#define ES_SPAN 16      // output rows a CTA owns
#define ES_U 8          // vectors a thread keeps in flight

struct ExecScatterArgs {
  unsigned* adj_out;
  const unsigned* adj_in;
  const unsigned* adj_rows;
  int* ts_out;
  const int* ts_in;
  const int* ts_rows;
  unsigned char* flag_out[3];
  const unsigned char* flag_in[3];
  const unsigned char* flag_rows[3];
  const int* idx;
  int cap, words, m;
  int adj_rows_vec;   // adj_rows 16-byte aligned and words % 4 == 0
};

// the CTA's vector g of its span (the adjacency's 4 * words vectors, then
// exec_ts's 12, then one a flag lane): its old value's and its output's
// address
__device__ __forceinline__ void es_vec_addr(const ExecScatterArgs& a, int r0,
                                            int g, const uint4** src,
                                            uint4** dst) {
  const int nadj = 4 * a.words;
  if (g < nadj) {
    const long long o = (long long)r0 * a.words / 4 + g;
    *src = reinterpret_cast<const uint4*>(a.adj_in) + o;
    *dst = reinterpret_cast<uint4*>(a.adj_out) + o;
  } else if (g < nadj + 12) {
    const long long o = (long long)r0 * 3 / 4 + (g - nadj);
    *src = reinterpret_cast<const uint4*>(a.ts_in) + o;
    *dst = reinterpret_cast<uint4*>(a.ts_out) + o;
  } else {
    const int k = g - nadj - 12;
    *src = reinterpret_cast<const uint4*>(a.flag_in[k] + r0);
    *dst = reinterpret_cast<uint4*>(a.flag_out[k] + r0);
  }
}

// vector g of the span with the dirty rows' elements taken from the row
// data (s_src: the source entry of each of the span's rows, -1 for none)
__device__ __forceinline__ uint4 es_patch(const ExecScatterArgs& a, int g,
                                          uint4 v, const int* s_src) {
  const int nadj = 4 * a.words;
  if (g < nadj) {
    const int e0 = g * 4;                    // first word, span-relative
    if (a.adj_rows_vec) {                    // the vector within one row
      const int r = e0 / a.words;
      const int i = s_src[r];
      if (i >= 0)
        v = reinterpret_cast<const uint4*>(
            a.adj_rows + (long long)i * a.words + (e0 - r * a.words))[0];
      return v;
    }
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (e0 + k) / a.words;
      const int i = s_src[r];
      if (i >= 0) w[k] = a.adj_rows[(long long)i * a.words + e0 + k -
                                    r * a.words];
    }
    return v;
  }
  if (g < nadj + 12) {
    const int e0 = (g - nadj) * 4;
    int* w = reinterpret_cast<int*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = (e0 + k) / 3;
      const int i = s_src[r];
      if (i >= 0) w[k] = a.ts_rows[i * 3 + e0 + k - r * 3];
    }
    return v;
  }
  const unsigned char* rows = a.flag_rows[g - nadj - 12];
  unsigned char* b = reinterpret_cast<unsigned char*>(&v);
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int i = s_src[k];
    if (i >= 0) b[k] = rows[i];
  }
  return v;
}

__global__ void __launch_bounds__(ES_THREADS)
exec_scatter_kernel(const __grid_constant__ ExecScatterArgs a) {
  __shared__ int s_src[ES_SPAN];
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * ES_SPAN;
  const int nv = 4 * a.words + 12 + 3;       // the span's vectors
  // the first ES_U vectors a thread, loaded before the index map is built
  uint4 buf[ES_U];
#pragma unroll
  for (int u = 0; u < ES_U; ++u) {
    const int g = tid + u * ES_THREADS;
    if (g < nv) {
      const uint4* src;
      uint4* dst;
      es_vec_addr(a, r0, g, &src, &dst);
      buf[u] = *src;
    }
  }
  if (tid < ES_SPAN) s_src[tid] = -1;
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < a.m; i += ES_THREADS) {
    const int r = norm_index(a.idx[i], a.cap);
    if (r >= r0 && r < r0 + ES_SPAN) {
      s_src[r - r0] = i;
      mine = 1;
    }
  }
  const int dirty = __syncthreads_or(mine);
  for (int base = 0; base < nv; base += ES_U * ES_THREADS) {
    if (base > 0) {
#pragma unroll
      for (int u = 0; u < ES_U; ++u) {
        const int g = base + tid + u * ES_THREADS;
        if (g < nv) {
          const uint4* src;
          uint4* dst;
          es_vec_addr(a, r0, g, &src, &dst);
          buf[u] = *src;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ES_U; ++u) {
      const int g = base + tid + u * ES_THREADS;
      if (g < nv) {
        const uint4* src;
        uint4* dst;
        es_vec_addr(a, r0, g, &src, &dst);
        *dst = dirty ? es_patch(a, g, buf[u], s_src) : buf[u];
      }
    }
  }
}

// fresh lanes (d_*) = the arena (s_*) with rows idx[i] set from the row
// data; every lane pointer 16-byte aligned (the wrapper's one allocation
// and the arena's own), cap % 32 == 0
extern "C" int exec_scatter(void* d_adj, void* d_ts, void* d_app,
                            void* d_pend, void* d_aw, const void* s_adj,
                            const void* s_ts, const void* s_app,
                            const void* s_pend, const void* s_aw, int cap,
                            int words, const void* idx, int m,
                            const void* r_adj, const void* r_ts,
                            const void* r_app, const void* r_pend,
                            const void* r_aw, void* stream) {
  if (cap < 0 || cap % 32 != 0 || words != cap / 32 || m < 0)
    return (int)cudaErrorInvalidValue;
  const void* lanes[10] = {d_adj, d_ts, d_app, d_pend, d_aw,
                           s_adj, s_ts, s_app, s_pend, s_aw};
  for (const void* p : lanes)
    if (((uintptr_t)p & 15u) != 0) return (int)cudaErrorMisalignedAddress;
  if (cap == 0) return 0;
  ExecScatterArgs a;
  a.adj_out = (unsigned*)d_adj;
  a.adj_in = (const unsigned*)s_adj;
  a.adj_rows = (const unsigned*)r_adj;
  a.ts_out = (int*)d_ts;
  a.ts_in = (const int*)s_ts;
  a.ts_rows = (const int*)r_ts;
  void* fo[3] = {d_app, d_pend, d_aw};
  const void* fi[3] = {s_app, s_pend, s_aw};
  const void* fr[3] = {r_app, r_pend, r_aw};
  for (int k = 0; k < 3; ++k) {
    a.flag_out[k] = (unsigned char*)fo[k];
    a.flag_in[k] = (const unsigned char*)fi[k];
    a.flag_rows[k] = (const unsigned char*)fr[k];
  }
  a.idx = (const int*)idx;
  a.cap = cap;
  a.words = words;
  a.m = m;
  a.adj_rows_vec = (words & 3) == 0 && ((uintptr_t)r_adj & 15u) == 0;
  exec_scatter_kernel<<<cap / ES_SPAN, ES_THREADS, 0,
                        (cudaStream_t)stream>>>(a);
  ACCORD_CHECK();
  return 0;
}
