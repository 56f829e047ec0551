// The parent's range body and K3 (csrc/range_block.cuh, node_resolve.cu's
// range side and csrc/arena_scatter.cu before their redesign), kept to
// time them beside the shipped ones on the same card in the same process:
// tools/range_block_variants.py builds this file alone and binds its three
// entries, whose C signatures are the shipped ones, in place of the
// shipped libraries'. Not built by ops/_ext.py.
//
// Range side: a memset of a [b, stride] scratch, one warp per (interval,
// 32-row word) OR-ing its overlap ballot into the scratch with a global
// atomicOr, then a mask kernel (one warp per row word over a 64-subject
// tile, one word a subject stored by lane 0) -- three stream operations a
// range block; the covered pass a memset and one warp per (interval,
// bucket word) with global atomics. The scratch is this file's own device
// buffer, grown only outside a graph capture (and never freed, so a graph
// captured over it stays valid). K3: five copies, a clear-rows kernel and
// a set-bits kernel with global atomics.
#include <string.h>

#include "common.cuh"

#define SUBJ_TILE 64   // the mask tile
#define WARPS 4        // its 32-row words per block

struct RngBlk {              // 48 bytes
  const int* start;
  const int* end;
  const int* ts;
  const int* kinds;
  const unsigned char* valid;
  int cap, out_off;
};

struct TabHdr {
  unsigned* out;
  long long nblk;
};

// one warp per (interval e, 32-bucket word wd) of the bucket slice [base,
// base + k_local) of k_total buckets: covered bits OR-ed into cov[o, wd]
// (cov [b, k_local/32], zeroed by the caller; one device: base 0, k_local
// == k_total)
__global__ void covered_kernel(const int* __restrict__ iv_of,
                               const int* __restrict__ iv_s,
                               const int* __restrict__ iv_e, int nv, int b,
                               int base, int k_local, int k,
                               unsigned* __restrict__ cov) {
  const int nw = k_local >> 5;
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
  const unsigned j = (unsigned)base + (unsigned)((wd << 5) + lane);
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

__global__ void node_range_any_kernel(const unsigned char* __restrict__ tab,
                                      const int* __restrict__ iv_of,
                                      const int* __restrict__ iv_s,
                                      const int* __restrict__ iv_e, int nv,
                                      int b, unsigned* __restrict__ anyr,
                                      int stride) {
  const RngBlk bk = ((const RngBlk*)(tab + sizeof(TabHdr)))[blockIdx.y];
  range_any_body(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                 threadIdx.x & 31, iv_of, iv_s, iv_e, nv, b, bk.start,
                 bk.end, bk.cap, anyr, stride, bk.out_off);
}

__global__ void __launch_bounds__(WARPS * 32)
node_range_mask_kernel(const unsigned char* __restrict__ tab,
                       const unsigned* __restrict__ anyr,
                       const int* __restrict__ subj_before,
                       const int* __restrict__ subj_kinds,
                       const int* __restrict__ subj_node,
                       const int* __restrict__ slots, int b,
                       const int* __restrict__ witness, int nk, int stride) {
  const TabHdr* h = (const TabHdr*)tab;
  const RngBlk bk = ((const RngBlk*)(tab + sizeof(TabHdr)))[blockIdx.z];
  if ((int)blockIdx.x * WARPS >= (bk.cap >> 5)) return;  // whole block
  range_mask_body(anyr, subj_before, subj_kinds, subj_node,
                  slots[blockIdx.z], b, bk.ts, bk.kinds, bk.valid, bk.cap,
                  witness, nk, h->out, stride, bk.out_off);
}


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

static unsigned* g_anyr = nullptr;
static size_t g_anyr_bytes = 0;

// the parent's scratch: at least `bytes`, grown only outside a capture
static int anyr_scratch(size_t bytes, cudaStream_t st, unsigned** out) {
  if (bytes > g_anyr_bytes) {
    cudaStreamCaptureStatus cs = cudaStreamCaptureStatusNone;
    cudaStreamIsCapturing(st, &cs);
    if (cs != cudaStreamCaptureStatusNone) return (int)cudaErrorInvalidValue;
    void* p = nullptr;
    const size_t want = bytes < (64u << 20) ? (64u << 20) : bytes;
    cudaError_t e = cudaMalloc(&p, want);
    if (e != cudaSuccess) return (int)e;
    g_anyr = (unsigned*)p;
    g_anyr_bytes = want;
  }
  *out = g_anyr;
  return 0;
}

// the parent's covered pass: per slice m a memset and the covered kernel
static int parent_covered(const void* iv_of, const void* iv_s,
                          const void* iv_e, int nv, int b, void* cov,
                          int cov_base, int k_local, int k_total, int slices,
                          cudaStream_t st) {
  const int nw = k_local >> 5;
  for (int m = 0; m < slices; ++m) {
    unsigned* c = (unsigned*)cov + (long long)m * b * nw;
    cudaMemsetAsync(c, 0, (size_t)b * nw * sizeof(unsigned), st);
    ACCORD_CHECK();
    const long long threads = (long long)nv * nw * 32;
    if (threads > 0 && b > 0) {
      covered_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
          (const int*)iv_of, (const int*)iv_s, (const int*)iv_e, nv, b,
          cov_base + m * k_local, k_local, k_total, c);
      ACCORD_CHECK();
    }
  }
  return 0;
}

// one range block, the parent's three operations
static int parent_block(const void* iv_of, const void* iv_s,
                        const void* iv_e, int nv, const void* subj_before,
                        const void* subj_kinds, const void* subj_store,
                        const int* slot, int b, const RngBlk& bk,
                        const void* witness, int nk, unsigned* anyr,
                        unsigned* out, int stride, cudaStream_t st) {
  const int words = bk.cap >> 5;
  if (words == 0 || b == 0) return 0;
  const int off = bk.out_off;
  cudaMemset2DAsync(anyr + off, (size_t)stride * sizeof(unsigned), 0,
                    (size_t)words * sizeof(unsigned), (size_t)b, st);
  ACCORD_CHECK();
  const long long threads = (long long)nv * words * 32;
  if (threads > 0) {
    range_any_kernel<<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
        (const int*)iv_of, (const int*)iv_s, (const int*)iv_e, nv, b,
        bk.start, bk.end, bk.cap, anyr, stride, off);
    ACCORD_CHECK();
  }
  dim3 grid((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE);
  range_mask_kernel<<<grid, WARPS * 32, 0, st>>>(
      anyr, (const int*)subj_before, (const int*)subj_kinds,
      (const int*)subj_store, slot, b, bk.ts, bk.kinds, bk.valid, bk.cap,
      (const int*)witness, nk, out, stride, off);
  ACCORD_CHECK();
  return 0;
}

// the shipped range_resolve's signature (kernels._RANGE_ARGS)
extern "C" int range_resolve(const void* spec, int nblk, const void* iv_of,
                             const void* iv_s, const void* iv_e, int nv,
                             const void* subj_before, const void* subj_kinds,
                             const void* subj_store, const void* slots,
                             int b, const void* witness, int nk,
                             int out_stride, void* cov, int cov_base,
                             int k_local, int k_total, int slices,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0) return 0;
  long long w[2];
  memcpy(w, spec, sizeof(w));
  if (nblk > 0) {
    unsigned* anyr = nullptr;
    int rc = anyr_scratch((size_t)b * out_stride * sizeof(unsigned), st,
                          &anyr);
    if (rc) return rc;
    for (int z = 0; z < nblk; ++z) {
      long long f[6];
      memcpy(f, (const char*)spec + sizeof(w) + sizeof(f) * z, sizeof(f));
      RngBlk bk;
      bk.start = (const int*)f[0];
      bk.end = (const int*)f[1];
      bk.ts = (const int*)f[2];
      bk.kinds = (const int*)f[3];
      bk.valid = (const unsigned char*)f[4];
      bk.cap = (int)(f[5] & 0xffffffffLL);
      bk.out_off = (int)(f[5] >> 32);
      rc = parent_block(iv_of, iv_s, iv_e, nv, subj_before, subj_kinds,
                        subj_store,
                        slots == nullptr ? nullptr : (const int*)slots + z,
                        b, bk, witness, nk, anyr, (unsigned*)w[0],
                        out_stride, st);
      if (rc) return rc;
    }
  }
  if (cov != nullptr)
    return parent_covered(iv_of, iv_s, iv_e, nv, b, cov, cov_base, k_local,
                          k_total, slices, st);
  return 0;
}

// the shipped node_range_resolve's signature (node_lane._NODE_RANGE_ARGS)
extern "C" int node_range_resolve(const void* tab, int nblocks, int max_cap,
                                  const void* iv_of, const void* iv_s,
                                  const void* iv_e, int nv,
                                  const void* subj_before,
                                  const void* subj_kinds,
                                  const void* subj_node, const void* slots,
                                  int b, const void* witness, int nk,
                                  int stride, void* cov, int cov_base,
                                  int k_local, int k_total, int slices,
                                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (b <= 0) return 0;
  if (nblocks > 0 && max_cap > 0) {
    unsigned* anyr = nullptr;
    int rc = anyr_scratch((size_t)b * stride * sizeof(unsigned), st, &anyr);
    if (rc) return rc;
    const int words = max_cap >> 5;
    cudaMemsetAsync(anyr, 0, (size_t)b * stride * sizeof(unsigned), st);
    ACCORD_CHECK();
    const long long threads = (long long)nv * words * 32;
    if (threads > 0) {
      dim3 g1((unsigned)((threads + 255) / 256), nblocks);
      node_range_any_kernel<<<g1, 256, 0, st>>>(
          (const unsigned char*)tab, (const int*)iv_of, (const int*)iv_s,
          (const int*)iv_e, nv, b, anyr, stride);
      ACCORD_CHECK();
    }
    dim3 g2((words + WARPS - 1) / WARPS, (b + SUBJ_TILE - 1) / SUBJ_TILE,
            nblocks);
    node_range_mask_kernel<<<g2, WARPS * 32, 0, st>>>(
        (const unsigned char*)tab, anyr, (const int*)subj_before,
        (const int*)subj_kinds, (const int*)subj_node, (const int*)slots, b,
        (const int*)witness, nk, stride);
    ACCORD_CHECK();
  }
  if (cov != nullptr)
    return parent_covered(iv_of, iv_s, iv_e, nv, b, cov, cov_base, k_local,
                          k_total, slices, st);
  return 0;
}

