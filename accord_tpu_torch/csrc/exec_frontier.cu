// K9: the exec plane's release frontier, one store or fused over a node's
// stores, and its compaction into exact released-row lists.
//
// Replaces accord_tpu/ops/kernels.py `execution_frontier` (:143, with the
// release test `_frontier_ready` :133), `fused_execution_frontier` (:174)
// and `frontier_compact` (:651, body `_frontier_compact_body` :619).
//
// Waiter row w of a plane is released iff pending[w] and no dep d has
//   adj[w, d] & ~applied[d] & (awaits_all[w] | exec_ts[d] <=lex exec_ts[w])
// over three signed int32 lanes (INT32_MIN in every lane while undecided:
// an undecided dep is <= everything and always gates; equal exec_ts gates
// too; adj[w, w] is treated like any other edge). The adjacency is packed
// int32 [cap, cap/32] (dep d in bit d & 31 of word d >> 5).
//
// Design: one block of 8 warps per 32-row output word. The block first
// packs its plane's applied lane into shared memory (one __ballot_sync per
// 32 rows), then each warp takes a waiter row at a time: rows that are not
// pending skip the scan; otherwise the lanes stride the row's words with
// g = adj_word & ~applied_word; for an awaits_all row any nonzero g gates,
// else the set bits of g are walked with __ffs and their exec_ts compared.
// __any_sync combines the lanes (and ends the scan at the first gate); the
// row's ready bit goes into the block's word by a shared atomicOr.
// The fused entry takes a table of planes (pointers, cap, first output
// word); caps may differ between planes, and the output is the planes'
// words concatenated. frontier_compact writes that fused frontier into its
// retained `packed` output, then runs the shared one-launch compaction
// (common.cuh's launch_csr: two launches a call, no memset) over S
// segments of the whole word range, where
// segment s keeps only plane s's word span -- the block-diagonal [S, w_tot]
// matrix of the JAX body -- so each row value is the GLOBAL bit index
// 32 * word + bit; indptr is exact past out_cap, rows beyond out_cap are
// dropped, and the checksum folds indptr and all out_cap rows with seeds
// 13 and 17.
//
// What bounds it: bytes, the pending rows' adjacency read once (cap^2/8,
// 32 MB at cap 16384 when every row is pending) plus 15 bytes of lanes per
// row; the word ANDs (cap^2/32) are far below the card's op rate. The
// applied lane is re-read from L2 by every block (cap bytes each).
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
