// The parents of K9 (csrc/exec_frontier.cu: execution_frontier, its fused
// entry and frontier_compact) and K20 (csrc/dense_dag.cu:
// execution_wavefronts), kept to time the shipped kernels beside them on
// the same card (tools/frontier_wavefront_variants.py binds these entries
// in place of the shipped ones: the same C names and signatures). Built
// only by that tool and by chip_smoke.py, never by ops/_ext.py.
//
// K9's parent: one block of 8 warps per 32-row output word; every block
// packs its plane's whole applied lane into shared memory first; a warp
// takes a row at a time, its lanes striding the row's words (a pass of 32
// words waits on __any_sync before the next pass's loads) and walking the
// surviving bits with __ffs, three dependent exec_ts loads a bit.
// frontier_compact writes the packed frontier, then runs common.cuh's
// launch_csr over the block-diagonal [S, w_tot] matrix: two launches.
// Its scratch need (a state per 1,024 words of S x w_tot) is never more
// than the shipped entry's (a state per output word), which the wrappers
// allocate.
//
// K20's parent: the bool matrix packed by one launch, a memset of the
// levels, one launch a round (a warp a row, `__ffs` over its set bits, a
// global level load each), and a copy: max_levels + 3 stream operations.
// Its entry takes the shipped signature (the `flags` scratch unused).

// ---------------------------------------------------------------- K9
#include "common.cuh"

#define FT 256          // threads per block (8 warps)
#define FMAXP 32        // planes per launch
#define FULL 0xffffffffu

struct FPlane {
  const unsigned* adj;
  const int* ts;
  const unsigned char* applied;
  const unsigned char* pending;
  const unsigned char* awaits;
  int cap;
  int word_off;  // first output word of this plane
};

struct FPlanes {
  FPlane p[FMAXP];
  int n;
};

__global__ void __launch_bounds__(FT)
frontier_kernel(const __grid_constant__ FPlanes ps,
                unsigned* __restrict__ out) {
  extern __shared__ unsigned s_app[];
  __shared__ unsigned s_word;
  const int gw = blockIdx.x;
  int pi = 0;
  while (pi + 1 < ps.n && gw >= ps.p[pi + 1].word_off) ++pi;
  const FPlane P = ps.p[pi];
  const int words = P.cap >> 5;
  const int lw = gw - P.word_off;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = warp; j < words; j += FT / 32) {
    const unsigned a = __ballot_sync(FULL, P.applied[(j << 5) + lane] != 0);
    if (lane == 0) s_app[j] = a;
  }
  if (threadIdx.x == 0) s_word = 0u;
  __syncthreads();
  for (int r = warp; r < 32; r += FT / 32) {
    const int w = (lw << 5) + r;
    if (!P.pending[w]) continue;  // uniform across the warp
    const int e0 = P.ts[w * 3], e1 = P.ts[w * 3 + 1], e2 = P.ts[w * 3 + 2];
    const bool all = P.awaits[w] != 0;
    const unsigned* row = P.adj + (long long)w * words;
    bool gated = false;
    for (int j0 = 0; j0 < words; j0 += 32) {
      const int j = j0 + lane;
      bool g = false;
      if (j < words) {
        unsigned v = row[j] & ~s_app[j];
        if (v != 0u && all) {
          g = true;
        } else {
          while (v != 0u) {
            const int d = (j << 5) + __ffs(v) - 1;
            // exec_ts[d] <=lex exec_ts[w]  ==  !(exec_ts[w] <lex exec_ts[d])
            if (!lex_before(e0, e1, e2, P.ts[d * 3], P.ts[d * 3 + 1],
                            P.ts[d * 3 + 2])) {
              g = true;
              break;
            }
            v &= v - 1u;
          }
        }
      }
      if (__any_sync(FULL, g)) {
        gated = true;
        break;
      }
    }
    if (!gated && lane == 0) atomicOr(&s_word, 1u << r);
  }
  __syncthreads();
  if (threadIdx.x == 0) out[gw] = s_word;
}

// the planes' table from the caller's arrays (n <= FMAXP); *w_tot = the
// output words; *smem = the largest plane's packed applied lane in bytes
static int make_planes(FPlanes* ps, int n, void* const* adj,
                       void* const* ts, void* const* applied,
                       void* const* pending, void* const* awaits,
                       const int* caps, int* w_tot, size_t* smem) {
  if (n < 1 || n > FMAXP) return (int)cudaErrorInvalidValue;
  int off = 0;
  size_t most = 0;
  for (int k = 0; k < n; ++k) {
    if (caps[k] <= 0 || caps[k] % 32) return (int)cudaErrorInvalidValue;
    ps->p[k] = FPlane{(const unsigned*)adj[k], (const int*)ts[k],
                      (const unsigned char*)applied[k],
                      (const unsigned char*)pending[k],
                      (const unsigned char*)awaits[k], caps[k], off};
    off += caps[k] / 32;
    size_t b = (size_t)(caps[k] / 32) * sizeof(unsigned);
    if (b > most) most = b;
  }
  ps->n = n;
  *w_tot = off;
  *smem = most;
  return 0;
}

static int launch_frontier(const FPlanes& ps, int w_tot, size_t smem,
                           unsigned* out, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(frontier_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    ACCORD_CHECK();
  }
  frontier_kernel<<<w_tot, FT, smem, st>>>(ps, out);
  ACCORD_CHECK();
  return 0;
}

// the fused frontier (n == 1: one store's execution_frontier) into
// out[w_tot]; the per-plane arrays hold device pointers and caps
extern "C" int exec_frontier(int n, void* const* adj, void* const* ts,
                             void* const* applied, void* const* pending,
                             void* const* awaits, const int* caps, void* out,
                             void* stream) {
  FPlanes ps;
  int w_tot;
  size_t smem;
  int rc = make_planes(&ps, n, adj, ts, applied, pending, awaits, caps,
                       &w_tot, &smem);
  if (rc != 0) return rc;
  return launch_frontier(ps, w_tot, smem, (unsigned*)out,
                         (cudaStream_t)stream);
}

// segment s of the block-diagonal [S, w_tot] matrix: the packed frontier's
// words inside plane s's span, zero elsewhere
struct FrontierSrc {
  const unsigned* packed;
  int w;  // w_tot: words per segment
  int off[FMAXP + 1];
  __device__ __forceinline__ unsigned word(int s, int j, long long,
                                           unsigned* kw) const {
    *kw = 0u;
    return (j >= off[s] && j < off[s + 1]) ? packed[j] : 0u;
  }
};

// frontier_compact: packed[w_tot] (retained), indptr[n+1], rows[out_cap],
// csum; scratch: kernels.csr_scratch_bytes(1, tiles of n * w_tot words)
// zeroed bytes, left zeroed
extern "C" int frontier_compact(int n, void* const* adj, void* const* ts,
                                void* const* applied, void* const* pending,
                                void* const* awaits, const int* caps,
                                int out_cap, void* packed, void* indptr,
                                void* rows, void* csum, void* scratch,
                                void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  FPlanes ps;
  int w_tot;
  size_t smem;
  int rc = make_planes(&ps, n, adj, ts, applied, pending, awaits, caps,
                       &w_tot, &smem);
  if (rc != 0) return rc;
  rc = launch_frontier(ps, w_tot, smem, (unsigned*)packed, st);
  if (rc != 0) return rc;
  FrontierSrc src;
  src.packed = (const unsigned*)packed;
  src.w = w_tot;
  for (int k = 0; k < n; ++k) src.off[k] = ps.p[k].word_off;
  src.off[n] = w_tot;
  return launch_csr(src, n, nullptr, out_cap, (int*)indptr, (int*)rows,
                    nullptr, nullptr, (unsigned*)csum, scratch, st,
                    FoldSeeds{13u, 17u, 0u});
}

// ---------------------------------------------------------------- K20
__global__ void pack_rows_kernel(const unsigned char* __restrict__ m,
                                 int rows, int n, int nw,
                                 unsigned* __restrict__ p) {
  const long long total = (long long)rows * nw;
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long f = (long long)blockIdx.x * (blockDim.x >> 5) +
                     (threadIdx.x >> 5);
       f < total; f += warps) {
    const long long i = f / nw;
    const int col = (int)(f % nw) * 32 + lane;
    const bool bit = col < n && m[i * n + col] != 0;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) p[f] = word;
  }
}

static inline int grid_cap(long long units, int per_block) {
  long long g = (units + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return (int)g;
}

// one round over rows [row0, row0 + nrows): p holds those rows packed
// ([nrows, nw]), lvl all n levels; lvl_out[r] for the block's row r
__global__ void wavefront_round_kernel(const unsigned* __restrict__ p,
                                       const int* __restrict__ lvl,
                                       int* __restrict__ lvl_out, int n,
                                       int nw, int row0, int nrows) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       i < nrows; i += warps) {
    int m = 0;
    for (int w = lane; w < nw; w += 32) {
      unsigned u = p[(long long)i * nw + w];
      while (u) {
        const int b = __ffs(u) - 1;
        u &= u - 1;
        m = max(m, lvl[w * 32 + b] + 1);
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = max(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) lvl_out[i] = max(lvl[row0 + i], m);
  }
}

// adj bool[n, n] -> out i32[n]; packed scratch [n, nw]; flags: unused (the
// shipped entry's barrier scratch). The second level buffer (the shipped
// entry takes none) is the parent's own, grown by an eager call (never
// inside a graph capture)
extern "C" int execution_wavefronts(const void* adj, int n, int max_levels,
                                    void* packed, void* out, void* flags,
                                    void* stream) {
  (void)flags;
  if (n <= 0) return 0;
  if (max_levels < 0) return (int)cudaErrorInvalidValue;
  static int* lb = nullptr;
  static int lb_n = 0;
  if (lb_n < n) {
    if (lb != nullptr) cudaFree(lb);
    if (cudaMalloc(&lb, sizeof(int) * (size_t)n) != cudaSuccess)
      return (int)cudaErrorMemoryAllocation;
    lb_n = n;
  }
  const int nw = (n + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  pack_rows_kernel<<<grid_cap((long long)n * nw, 8), 256, 0, st>>>(
      (const unsigned char*)adj, n, n, nw, (unsigned*)packed);
  ACCORD_CHECK();
  int* cur = (int*)out;
  int* nxt = lb;
  cudaMemsetAsync(cur, 0, sizeof(int) * (size_t)n, st);
  const int grid = grid_cap(n, 8);
  for (int r = 0; r < max_levels; ++r) {
    wavefront_round_kernel<<<grid, 256, 0, st>>>((const unsigned*)packed,
                                                 cur, nxt, n, nw, 0, n);
    ACCORD_CHECK();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != (int*)out) launch_copy((int*)out, (const int*)cur, n, st);
  ACCORD_CHECK();
  return 0;
}
