// K18-K21: the execute-DAG kernels over dense and packed boolean matrices.
//
// Packed rows are 32-bit words, column 32*w + i in bit i of word w, as
// everywhere in the port (common.cuh).
//
// K18 deps_matrix -- replaces accord_tpu/ops/kernels.py `deps_matrix` (:36).
//   dep[b, a] = overlap(b, a) & witness[kind_b, kind_a] == 1
//               & act_ts[a] <lex subj_before[b] & act_valid[a]
//   The reference's overlap is a bf16 matmul of 0/1 bitmaps > 0.5; here the
//   bitmaps arrive packed (i32[., K/32]), exactly as the tensor cores'
//   binary MMA takes them, and the overlap is popc(subj & act) > 0, which
//   is exact. Bound: bytes, the bool output (67 MB at B 4,096, A 16,384)
//   and both bitmaps read once, ~0.02 ms. The B*A*K/32 word ANDs (2.1 G
//   at K 1,024) run on the tensor cores, whose b1 rate the H100's data
//   sheet does not publish; on the CUDA cores (64 lanes of 32-bit logic a
//   clock an SM) the AND-ORs alone would take ~0.13 ms.
//   Design (shipped): `mma.sync.m16n8k256.row.col.s32.b1.b1.s32.and.popc`.
//   A block of 16 warps takes 128 subjects x 128 actives, a warp 32 x 32
//   as 2 x 4 MMA tiles (k 256 bits = 8 words a step). 16-word chunks of
//   both bitmaps stream row-major into shared memory by 16-byte cp.async,
//   double-buffered, the row pitch 20 words so a fragment's 8 rows x 4
//   words fall on 32 banks. The counts become one overlap bit each; the
//   tile's subject and active lanes (ts, kind, valid), staged in shared
//   memory while the first chunk is in flight, are read only where a bit
//   is set, and the tile's bytes leave through shared memory as 16-byte
//   stores.
//   The CUDA-core form (8 x 8 accumulators a thread, walking each
//   subject row's nonzero words) lost to it and is kept only as
//   tools/dense_dag_cuda_cores.cu, which tools/dense_dag_variants.py
//   times.
//
// K19 transitive_closure -- replaces `transitive_closure` (:97):
//   R |= (R @ R > 0.5), exactly `iterations` launches (Jacobi: each
//   squaring reads the previous R, writes a second buffer). On packed
//   rows, R @ R's row i is the OR of the rows k with R[i, k] set: a
//   blocked boolean product. A block owns a tile of 64 rows x 128 words;
//   k streams in chunks of 32 rows (one word of each tile row), the
//   chunk's [32 x 128] words staged in shared memory by cp.async,
//   double-buffered. A warp keeps 8 rows x 4 words a lane in registers:
//   one 16-byte shared load of row k's words serves each of the warp's
//   rows with bit k set (predicated ORs). Zero words are skipped: a chunk
//   whose words are zero in every tile row is never loaded, a warp walks
//   only the bits set in the union of its rows' words. R's L2 traffic is
//   N^2 x nw x 4 / 64 bytes a squaring (was up to N^2 x nw x 4 / 8).
//   Blocks are persistent (one an SM) and take tiles from an atomic
//   counter, last rows first, which balances the triangular DAGs the port
//   closes. Early exit, exact: each squaring records in zeroed scratch
//   whether any word changed; one whose predecessor changed nothing
//   returns at once (if R_{i+1} == R_i every later R equals it, and the
//   ping-pong already holds R in both buffers). So the launch count is
//   fixed and the call can be captured in a CUDA graph. The bool[N, N]
//   input is packed first and the result unpacked last; the unpack
//   clears the flags. No limit on N but memory. Bound: operations, the
//   word ORs this data needs (set bits x N/32 of each squaring up to and
//   including the first that changes nothing).
//
// K20 execution_wavefronts -- replaces `execution_wavefronts` (:113):
//   level'[i] = max(level[i], max_j adj[i, j] * (level[j] + 1)), from
//   zeros, `max_levels` Jacobi rounds, which give min(max_levels, L(i)),
//   L(i) the longest dependency path from i (infinite on a cycle). ONE
//   persistent cooperative launch (see wavefront_kernel): a block owns a
//   run of rows, packs them from the bool matrix itself and keeps their
//   column lists in shared memory (a row too wide for them is read packed
//   from L2), then updates the levels in place, clamped at max_levels,
//   KW_SWEEPS sweeps between grid barriers, each sweep reading a copy of
//   the levels refreshed into shared memory; the barrier carries whether
//   any level changed, and the first phase that changes none ends the
//   work (exact: the fixpoint is the answer). Bound: bytes, the bool
//   matrix read once (67 MB at N 8,192). The shard entry `wavefront_rows`
//   keeps the one-round kernel.
//
// K21 dag_wavefronts_packed -- replaces `dag_wavefronts_packed` (:197):
//   per round r: blocked[i] = any_w(adj[i, w] & ~applied[w]); ready =
//   !blocked & level < 0; level[i] = r for ready rows, whose bits join
//   the NEXT round's applied set (Jacobi: a row settled in round r
//   releases nothing in round r). ONE persistent cooperative launch over
//   the grid the occupancy API shows fits the card at once, a grid
//   barrier between rounds (see dag_settle_kernel). Exact shortcuts: a
//   round that settles no row ends the work (applied stops changing, so
//   every later round is a no-op); a round walks only the rows still
//   unsettled (each lane keeps a mask of its live rows); a row keeps the
//   words that blocked it (applied only grows, so a word that stopped
//   blocking never blocks again), so the adjacency (1.25 GB at N =
//   100,000) is read about once in all, most of it in round 0, and a
//   later round reads a few kept words a live row. Bound:
//   bytes, the adjacency read once (~0.37 ms at 3.35 TB/s).
//
// A mesh shard's entries (accord_tpu_torch/parallel/mesh.py
// `sharded_deps_step`, replacing the JAX package's parallel/mesh.py
// `sharded_deps_step` :89): `deps_matrix_strided` runs K18 on a 'data' row
// block of subjects and a 'model' word slice of both bitmaps, read in
// place through row strides (the 'model' partials merge by OR in
// csrc/mesh_combine.cu); `pack_rows` packs a bool row block; `closure_rows`
// squares a row block against the gathered full matrix (one Jacobi round
// of K19, without the early exit) and `wavefront_rows` runs one K20 round
// over a row block against the gathered levels. One launch per shard per
// round. Bound: K18's, K19's and K20's, each on its block's share of the
// work; the gathered matrix is read from the shard's device, so a round
// adds no bytes on one card.
#include "common.cuh"

// 4-byte asynchronous copy global -> shared; `ok` false fills zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

// 16-byte asynchronous copy; `ok` false fills zeros
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest `n` complete
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// ---------------------------------------------------------------- K18
// gather rules of the reference's witness lookup: a negative kind counts
// from the end, then clamps into [0, nk)
__device__ __forceinline__ int kind_index(int k, int nk) {
  if (k < 0) k += nk;
  return k < 0 ? 0 : (k >= nk ? nk - 1 : k);
}

#define DM_KC 16  // words a staged chunk
#define DM_TH 512
#define DMB_MI 2    // 16-row MMA tiles a warp holds
#define DMB_NJ 4    // 8-column MMA tiles a warp holds
#define DMB_WM 4    // warps along the subjects (the rest along the actives)
#define DMB_MINB 2  // blocks an SM (caps the registers: 64 a thread)
#define DM_TB (DMB_WM * DMB_MI * 16)                    // subjects a tile
#define DM_TA ((DM_TH / 32 / DMB_WM) * DMB_NJ * 8)      // actives a tile
#define DM_PW 20   // [row][word] pitch: 20 = 4 x odd keeps a fragment
                   // load's 8 rows x 4 words on 32 banks
#define DM_STAGE ((DM_TB + DM_TA) * DM_PW)

// what a tile's epilogue reads: subject and active lanes, staged once
struct DmLanes {
  int sts[DM_TB][3];
  int skind[DM_TB];  // clamped kind; -1 past B
  int ats[DM_TA][3];
  int akind[DM_TA];  // clamped kind; -1 past A or invalid
};

// the operand stages, the lanes; the tile's bytes reuse the stages
struct DmSmem {
  unsigned stage[2][DM_STAGE];
  DmLanes lanes;
};
// the tile's bytes as rows padded 16 bytes (a warp's writes spread over
// the banks), staged in the operand stages once they are spent
#define DM_OP (DM_TA + 16)
static_assert(DM_TB * DM_OP <= sizeof(unsigned) * 2 * DM_STAGE,
              "the staged output tile must fit the operand stages");

__device__ __forceinline__ void dm_stage_lanes(
    DmLanes& L, const int* __restrict__ sb, const int* __restrict__ sk,
    const int* __restrict__ at, const int* __restrict__ ak,
    const unsigned char* __restrict__ av, int nk0, int nk1, int B, int A,
    int b0, int a0) {
  for (int q = threadIdx.x; q < DM_TB; q += DM_TH) {
    const int b = b0 + q;
    const bool ok = b < B;
    L.sts[q][0] = ok ? sb[3LL * b] : 0;
    L.sts[q][1] = ok ? sb[3LL * b + 1] : 0;
    L.sts[q][2] = ok ? sb[3LL * b + 2] : 0;
    L.skind[q] = ok ? kind_index(sk[b], nk0) : -1;
  }
  for (int q = threadIdx.x; q < DM_TA; q += DM_TH) {
    const int a = a0 + q;
    const bool in = a < A;  // every load issued at once
    const int t0 = in ? at[3LL * a] : 0, t1 = in ? at[3LL * a + 1] : 0;
    const int t2 = in ? at[3LL * a + 2] : 0, k = in ? ak[a] : 0;
    const bool ok = in && av[a];
    L.ats[q][0] = t0;
    L.ats[q][1] = t1;
    L.ats[q][2] = t2;
    L.akind[q] = ok ? kind_index(k, nk1) : -1;
  }
}

// overlap known: the rest of the predicate for tile row r, tile column c
__device__ __forceinline__ bool dm_dep(const DmLanes& L,
                                       const int* __restrict__ wt, int nk1,
                                       int r, int c) {
  const int sk = L.skind[r], ak = L.akind[c];
  return sk >= 0 && ak >= 0 && wt[sk * nk1 + ak] == 1 &&
         lex_before(L.ats[c][0], L.ats[c][1], L.ats[c][2], L.sts[r][0],
                    L.sts[r][1], L.sts[r][2]);
}

// the tile's bytes (s_out [DM_TB][DM_OP]) to out: 16-byte stores where
// the rows allow, else bytes
__device__ __forceinline__ void dm_store(const unsigned char* s_out,
                                         unsigned char* __restrict__ out,
                                         int B, int A, int b0, int a0) {
  const bool vec = (A & 15) == 0 && a0 + DM_TA <= A &&
                   (((uintptr_t)out) & 15u) == 0;
  if (vec) {
    for (int e = threadIdx.x; e < DM_TB * (DM_TA / 16); e += DM_TH) {
      const int r = e / (DM_TA / 16), c = e % (DM_TA / 16);
      if (b0 + r < B)
        *(uint4*)(out + (long long)(b0 + r) * A + a0 + 16 * c) =
            *(const uint4*)(s_out + r * DM_OP + 16 * c);
    }
  } else {
    for (int e = threadIdx.x; e < DM_TB * DM_TA; e += DM_TH) {
      const int r = e / DM_TA, c = e % DM_TA;
      if (b0 + r < B && a0 + c < A)
        out[(long long)(b0 + r) * A + a0 + c] = s_out[r * DM_OP + c];
    }
  }
}

// chunk [k0, k0 + DM_KC) of the tile's rows, [row][word] (zeros past an
// edge)
__device__ __forceinline__ void dm_load(unsigned* st,
                                        const unsigned* __restrict__ sw,
                                        const unsigned* __restrict__ aw,
                                        int B, int A, int kw, int sws,
                                        int aws, int b0, int a0, int k0,
                                        bool vec) {
  if (vec) {  // 16-byte copies: 4 words of a row
    for (int e = threadIdx.x; e < (DM_TB + DM_TA) * (DM_KC / 4);
         e += DM_TH) {
      const int r = e / (DM_KC / 4), w = 4 * (e % (DM_KC / 4));
      const bool subj = r < DM_TB;
      const int row = subj ? b0 + r : a0 + r - DM_TB;
      const bool ok = (subj ? row < B : row < A) && k0 + w < kw;
      const unsigned* src = subj ? sw + (long long)row * sws + k0 + w
                                 : aw + (long long)row * aws + k0 + w;
      cp_async16(st + r * DM_PW + w, ok ? src : sw, ok);
    }
    return;
  }
  for (int e = threadIdx.x; e < (DM_TB + DM_TA) * DM_KC; e += DM_TH) {
    const int r = e / DM_KC, w = e % DM_KC;
    const bool subj = r < DM_TB;
    const int row = subj ? b0 + r : a0 + r - DM_TB;
    const bool ok = (subj ? row < B : row < A) && k0 + w < kw;
    const unsigned* src = subj ? sw + (long long)row * sws + k0 + w
                               : aw + (long long)row * aws + k0 + w;
    cp_async4(st + r * DM_PW + w, ok ? src : sw, ok);
  }
}

__device__ __forceinline__ void mma_b1(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(DM_TH, DMB_MINB)
deps_matrix_kernel(const unsigned* __restrict__ sw, const int* __restrict__ sb,
                   const int* __restrict__ sk, const unsigned* __restrict__ aw,
                   const int* __restrict__ at, const int* __restrict__ ak,
                   const unsigned char* __restrict__ av,
                   const int* __restrict__ wt, int nk0, int nk1, int B, int A,
                   int kw, int sws, int aws, unsigned char* __restrict__ out) {
  static_assert(DMB_MI * DMB_NJ * 4 <= 64, "a thread's outputs: 64 bits");
  __shared__ __align__(16) DmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % DMB_WM, wn = warp / DMB_WM;
  const int b0 = blockIdx.y * DM_TB, a0 = blockIdx.x * DM_TA;
  int acc[DMB_MI][DMB_NJ][4];
#pragma unroll
  for (int i = 0; i < DMB_MI; ++i)
#pragma unroll
    for (int j = 0; j < DMB_NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0;
  const int nch = (kw + DM_KC - 1) / DM_KC;
  const bool vec = ((kw | sws | aws) & 3) == 0 &&
                   ((((uintptr_t)sw) | ((uintptr_t)aw)) & 15u) == 0;
  if (nch > 0)
    dm_load(sm.stage[0], sw, aw, B, A, kw, sws, aws, b0, a0, 0, vec);
  cp_async_commit();
  // the epilogue's lanes load while the first chunk is in flight
  dm_stage_lanes(sm.lanes, sb, sk, at, ak, av, nk0, nk1, B, A, b0, a0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch)
      dm_load(sm.stage[(c + 1) & 1], sw, aw, B, A, kw, sws, aws, b0, a0,
              (c + 1) * DM_KC, vec);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned* S = sm.stage[c & 1];
    const unsigned* T = S + DM_TB * DM_PW;
    const int steps = (min(DM_KC, kw - c * DM_KC) + 7) / 8;
    for (int ks = 0; ks < steps; ++ks) {
      unsigned fa[DMB_MI][4], fb[DMB_NJ][2];
#pragma unroll
      for (int i = 0; i < DMB_MI; ++i) {
        const unsigned* p =
            S + (wm * DMB_MI * 16 + i * 16 + gid) * DM_PW + ks * 8;
        fa[i][0] = p[tig];
        fa[i][1] = p[8 * DM_PW + tig];
        fa[i][2] = p[4 + tig];
        fa[i][3] = p[8 * DM_PW + 4 + tig];
      }
#pragma unroll
      for (int j = 0; j < DMB_NJ; ++j) {
        const unsigned* p =
            T + (wn * DMB_NJ * 8 + j * 8 + gid) * DM_PW + ks * 8;
        fb[j][0] = p[tig];
        fb[j][1] = p[4 + tig];
      }
#pragma unroll
      for (int i = 0; i < DMB_MI; ++i)
#pragma unroll
        for (int j = 0; j < DMB_NJ; ++j) mma_b1(acc[i][j], fa[i], fb[j]);
    }
    __syncthreads();
  }
  // the overlaps as bits (the counts die here), the tile's bytes zeroed,
  // then the rest of the predicate where a bit is set (rare)
  unsigned long long ov = 0ull;
#pragma unroll
  for (int i = 0; i < DMB_MI; ++i)
#pragma unroll
    for (int j = 0; j < DMB_NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (acc[i][j][q] > 0) ov |= 1ull << ((i * DMB_NJ + j) * 4 + q);
  __syncthreads();
  unsigned char* s_out = (unsigned char*)sm.stage;
  for (int e = threadIdx.x; e < DM_TB * DM_OP / 16; e += DM_TH)
    ((uint4*)s_out)[e] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  while (ov) {
    const int b = __ffsll(ov) - 1;
    ov &= ov - 1ull;
    const int i = b / (4 * DMB_NJ), j = (b / 4) % DMB_NJ, q = b % 4;
    const int r = wm * DMB_MI * 16 + i * 16 + gid + 8 * (q >> 1);
    const int c = wn * DMB_NJ * 8 + j * 8 + 2 * tig + (q & 1);
    if (dm_dep(sm.lanes, wt, nk1, r, c)) s_out[r * DM_OP + c] = 1;
  }
  __syncthreads();
  dm_store(s_out, out, B, A, b0, a0);
}

// sw's and aw's rows start sws and aws words apart (kw of them used)
extern "C" int deps_matrix_strided(const void* sw, int sws, const void* sb,
                                   const void* sk, const void* aw, int aws,
                                   const void* at, const void* ak,
                                   const void* av, const void* wt, int nk0,
                                   int nk1, int B, int A, int kw, void* out,
                                   void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (nk0 <= 0 || nk1 <= 0 || kw < 0 || sws < kw || aws < kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((A + DM_TA - 1) / DM_TA, (B + DM_TB - 1) / DM_TB);
  deps_matrix_kernel<<<grid, DM_TH, 0, st>>>(
      (const unsigned*)sw, (const int*)sb, (const int*)sk,
      (const unsigned*)aw, (const int*)at, (const int*)ak,
      (const unsigned char*)av, (const int*)wt, nk0, nk1, B, A, kw, sws, aws,
      (unsigned char*)out);
  ACCORD_CHECK();
  return 0;
}

extern "C" int deps_matrix(const void* sw, const void* sb, const void* sk,
                           const void* aw, const void* at, const void* ak,
                           const void* av, const void* wt, int nk0, int nk1,
                           int B, int A, int kw, void* out, void* stream) {
  return deps_matrix_strided(sw, kw, sb, sk, aw, kw, at, ak, av, wt, nk0, nk1,
                             B, A, kw, out, stream);
}

// ------------------------------------------------- packing (K19, K20)
// bool[rows, n] -> packed [rows, nw]: a warp packs 32 columns of a row
// (ballot)
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

// packed [n, nw] -> bool[n, n]; the first thread also hands K19's count
// of squarings that did work (0 without a squaring) to `worked` (if
// given) and clears the flags
__global__ void unpack_rows_kernel(const unsigned* __restrict__ p, int n,
                                   int nw, unsigned char* __restrict__ m,
                                   unsigned* __restrict__ flags,
                                   int* __restrict__ worked, bool squared) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    if (worked) *worked = squared ? (int)flags[4] : 0;
    flags[3] = 0u;
    flags[4] = 0u;
  }
  const long long total = (long long)n * n;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long i = e / n;
    const int j = (int)(e % n);
    m[e] = (p[i * nw + (j >> 5)] >> (j & 31)) & 1u;
  }
}

static inline int grid_cap(long long units, int per_block) {
  long long g = (units + per_block - 1) / per_block;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  return (int)g;
}

static inline void launch_pack(const unsigned char* m, int rows, int n,
                               int nw, unsigned* p, cudaStream_t st) {
  pack_rows_kernel<<<grid_cap((long long)rows * nw, 8), 256, 0, st>>>(
      m, rows, n, nw, p);
}

// bool[rows, n] -> packed [rows, ceil(n/32)]
extern "C" int pack_rows(const void* m, int rows, int n, void* p,
                         void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  launch_pack((const unsigned char*)m, rows, n, (n + 31) / 32, (unsigned*)p,
              (cudaStream_t)stream);
  ACCORD_CHECK();
  return 0;
}

// ---------------------------------------------------------------- K19
#define CT_RPW 8                       // rows a warp holds
#define CT_WARPS 8
#define CT_TH (32 * CT_WARPS)
#define CT_ROWS (CT_RPW * CT_WARPS)    // 64 rows a tile
#define CT_W 128                       // words a tile: 32 lanes x 4
#define CT_SEG 1024                    // chunks one nonzero mask covers
// the flags scratch (zeroed, left zeroed; ops/kernels.py
// _CLOSURE_FLAG_BYTES): tile counter, ticket, changed, done, squarings
// that did work
#define CT_FLAGS 5

// chunk kc of the tile: rows 32kc.. of r, words [w0, w0 + CT_W), and the
// tile rows' word kc (zeros past an edge)
__device__ __forceinline__ void ct_load(unsigned (*sb)[CT_W], unsigned* sa,
                                        const unsigned* __restrict__ r,
                                        int n, int nw, int i0, int ie,
                                        int w0, int kc, bool vec) {
  const long long k0 = 32LL * kc;
  if (vec) {
    for (int e = threadIdx.x; e < 32 * (CT_W / 4); e += CT_TH) {
      const int kr = e / (CT_W / 4), w = 4 * (e % (CT_W / 4));
      const bool ok = k0 + kr < n && w0 + w < nw;
      cp_async16(&sb[kr][w], ok ? r + (k0 + kr) * nw + w0 + w : r, ok);
    }
  } else {
    for (int e = threadIdx.x; e < 32 * CT_W; e += CT_TH) {
      const int kr = e / CT_W, w = e % CT_W;
      const bool ok = k0 + kr < n && w0 + w < nw;
      cp_async4(&sb[kr][w], ok ? r + (k0 + kr) * nw + w0 + w : r, ok);
    }
  }
  for (int q = threadIdx.x; q < CT_ROWS; q += CT_TH) {
    const bool ok = i0 + q < ie;
    cp_async4(&sa[q], ok ? r + (long long)(i0 + q) * nw + kc : r, ok);
  }
}

// rows [row0, row0 + nrows) of one squaring of the full packed r [n, nw],
// written to rn[(i - row0) * nw ...]. Persistent blocks take tiles from
// flags[0]; the last block to finish (ticket flags[1]) resets them. With
// `track` 1: a block that finds flags[3] (done) set returns at once; else
// flags[2] records a changed word, and the last block sets done when
// nothing changed and counts the squaring in flags[4]. `track` 2 is a
// call's first squaring: it reads no done and restarts the count, so
// flags a faulted call left set cost one squaring's work, not a wrong
// answer.
__global__ void __launch_bounds__(CT_TH, 1)
closure_tile_kernel(const unsigned* __restrict__ r, unsigned* __restrict__ rn,
                    int n, int nw, int row0, int nrows,
                    unsigned* __restrict__ flags, int track) {
  __shared__ __align__(16) unsigned s_b[2][32][CT_W];
  __shared__ __align__(16) unsigned s_a[2][CT_ROWS];
  __shared__ unsigned s_nz[CT_SEG / 32];
  __shared__ int s_tile;
  volatile unsigned* vf = flags;
  if (track == 1 && vf[3]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ctiles = (nw + CT_W - 1) / CT_W;
  const int ntiles = ((nrows + CT_ROWS - 1) / CT_ROWS) * ctiles;
  const bool vec = (nw & 3) == 0 && (((uintptr_t)r) & 15u) == 0 &&
                   (((uintptr_t)rn) & 15u) == 0;
  bool changed = false;
  for (;;) {
    if (threadIdx.x == 0) s_tile = (int)atomicAdd(&flags[0], 1u);
    __syncthreads();
    const int t = s_tile;
    if (t >= ntiles) break;
    const int tt = ntiles - 1 - t;  // last rows first
    const int i0 = row0 + (tt / ctiles) * CT_ROWS;
    const int ie = min(i0 + CT_ROWS, row0 + nrows);
    const int w0 = (tt % ctiles) * CT_W;
    unsigned acc[CT_RPW][4];
#pragma unroll
    for (int q = 0; q < CT_RPW; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][j] = 0u;
    for (int seg0 = 0; seg0 < nw; seg0 += CT_SEG) {
      const int slen = min(CT_SEG, nw - seg0);
      // which of the segment's chunks hold a set bit in some tile row
      __syncthreads();  // every thread is done with the last mask
      for (int q = threadIdx.x; q < CT_SEG / 32; q += CT_TH) s_nz[q] = 0u;
      __syncthreads();
      for (int c = threadIdx.x; c < slen; c += CT_TH) {
        unsigned v = 0u;
#pragma unroll 8
        for (int i = i0; i < ie; ++i) v |= r[(long long)i * nw + seg0 + c];
        if (v) atomicOr(&s_nz[c >> 5], 1u << (c & 31));
      }
      __syncthreads();
      auto next = [&](int c) {
        while (c < slen) {
          const unsigned m = s_nz[c >> 5] >> (c & 31);
          if (m) return c + __ffs(m) - 1;
          c = (c | 31) + 1;
        }
        return slen;
      };
      int c = next(0), st = 0;
      if (c < slen)
        ct_load(s_b[0], s_a[0], r, n, nw, i0, ie, w0, seg0 + c, vec);
      cp_async_commit();
      while (c < slen) {
        const int cn = next(c + 1);
        if (cn < slen)
          ct_load(s_b[st ^ 1], s_a[st ^ 1], r, n, nw, i0, ie, w0, seg0 + cn,
                  vec);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        unsigned a[CT_RPW], u = 0u;
        const uint4 a0 = *(const uint4*)&s_a[st][warp * CT_RPW];
        const uint4 a1 = *(const uint4*)&s_a[st][warp * CT_RPW + 4];
        a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
        a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
        for (int q = 0; q < CT_RPW; ++q) u |= a[q];
        while (u) {  // the bits set in the warp's rows (uniform)
          const int b = __ffs(u) - 1;
          u &= u - 1u;
          const unsigned bm = 1u << b;
          const uint4 v = *(const uint4*)&s_b[st][b][4 * lane];
#pragma unroll
          for (int q = 0; q < CT_RPW; ++q)
            if (a[q] & bm) {
              acc[q][0] |= v.x;
              acc[q][1] |= v.y;
              acc[q][2] |= v.z;
              acc[q][3] |= v.w;
            }
        }
        __syncthreads();
        c = cn;
        st ^= 1;
      }
    }
    // rn = r | acc on the tile's words
#pragma unroll
    for (int q = 0; q < CT_RPW; ++q) {
      const int i = i0 + warp * CT_RPW + q;
      if (i >= ie) break;
      const long long src = (long long)i * nw + w0 + 4 * lane;
      const long long dst = (long long)(i - row0) * nw + w0 + 4 * lane;
      if (vec && w0 + 4 * lane < nw) {
        const uint4 o = *(const uint4*)(r + src);
        const uint4 x = make_uint4(o.x | acc[q][0], o.y | acc[q][1],
                                   o.z | acc[q][2], o.w | acc[q][3]);
        changed |= x.x != o.x || x.y != o.y || x.z != o.z || x.w != o.w;
        *(uint4*)(rn + dst) = x;
      } else if (!vec) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (w0 + 4 * lane + j < nw) {
            const unsigned o = r[src + j], x = o | acc[q][j];
            changed |= x != o;
            rn[dst + j] = x;
          }
      }
    }
  }
  // the block's verdict, then the ticket
  const bool any = __syncthreads_or(changed) != 0;
  __shared__ bool s_last;
  if (threadIdx.x == 0) {
    if (track && any) atomicOr(&flags[2], 1u);
    __threadfence();
    s_last = atomicAdd(&flags[1], 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (s_last && threadIdx.x == 0) {
    __threadfence();
    if (track) {
      vf[3] = vf[2] == 0u ? 1u : 0u;
      vf[4] = track == 2 ? 1u : vf[4] + 1u;
      vf[2] = 0u;
    }
    vf[0] = 0u;
    vf[1] = 0u;
  }
}

static inline int closure_launch(const unsigned* r, unsigned* rn, int n,
                                 int nw, int row0, int nrows,
                                 unsigned* flags, int track,
                                 cudaStream_t st) {
  const long long tiles = (long long)((nrows + CT_ROWS - 1) / CT_ROWS) *
                          ((nw + CT_W - 1) / CT_W);
  const int sms = sm_count();
  const int grid = (int)(tiles < sms ? tiles : sms);
  closure_tile_kernel<<<grid, CT_TH, 0, st>>>(r, rn, n, nw, row0, nrows,
                                              flags, track);
  return 0;
}

// adj bool[n, n] -> out bool[n, n]; pa, pb packed scratch [n, nw]; flags
// zeroed scratch [CT_FLAGS] (left zeroed); worked (nullable) i32[1]: the
// squarings that did work
extern "C" int transitive_closure(const void* adj, int n, int iterations,
                                  void* pa, void* pb, void* out, void* flags,
                                  void* worked, void* stream) {
  if (n <= 0) return 0;
  if (iterations < 0 || flags == nullptr) return (int)cudaErrorInvalidValue;
  const int nw = (n + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* cur = (unsigned*)pa;
  unsigned* nxt = (unsigned*)pb;
  launch_pack((const unsigned char*)adj, n, n, nw, cur, st);
  ACCORD_CHECK();
  for (int it = 0; it < iterations; ++it) {
    closure_launch(cur, nxt, n, nw, 0, n, (unsigned*)flags, it ? 1 : 2,
                   st);
    ACCORD_CHECK();
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }
  unpack_rows_kernel<<<grid_for((long long)n * n, 256), 256, 0, st>>>(
      cur, n, nw, (unsigned char*)out, (unsigned*)flags, (int*)worked,
      iterations > 0);
  ACCORD_CHECK();
  return 0;
}

// rows [row0, row0 + nrows) of one closure squaring: full r [n, nw] on the
// device, the block's rows written to rn [nrows, nw]; flags as above
extern "C" int closure_rows(const void* r, int n, int row0, int nrows,
                            void* rn, void* flags, void* stream) {
  if (n <= 0 || nrows <= 0) return 0;
  if (row0 < 0 || row0 + nrows > n || flags == nullptr)
    return (int)cudaErrorInvalidValue;
  closure_launch((const unsigned*)r, (unsigned*)rn, n, (n + 31) / 32, row0,
                 nrows, (unsigned*)flags, 0, (cudaStream_t)stream);
  ACCORD_CHECK();
  return 0;
}


// ---------------------------------------------------------------- K20
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

// one round over a packed row block p [nrows, ceil(n/32)] against all n
// levels lvl; the block's new levels to lvl_out [nrows]
extern "C" int wavefront_rows(const void* p, const void* lvl, int n,
                              int row0, int nrows, void* lvl_out,
                              void* stream) {
  if (n <= 0 || nrows <= 0) return 0;
  if (row0 < 0 || row0 + nrows > n) return (int)cudaErrorInvalidValue;
  wavefront_round_kernel<<<grid_cap(nrows, 8), 256, 0,
                           (cudaStream_t)stream>>>(
      (const unsigned*)p, (const int*)lvl, (int*)lvl_out, n, (n + 31) / 32,
      row0, nrows);
  ACCORD_CHECK();
  return 0;
}

// The K20 kernel's sizes: KW_TH threads a block (a block an SM); one
// block up to KW_ONE rows (its levels in shared memory only, no grid
// barrier), else at least KW_ROWS rows a block; KW_SMEM bytes of dynamic
// shared memory a block, holding the block's row slots, its rows' column
// lists and a copy of the levels (up to KW_LVL bytes of them, else they
// are read from L2); KW_U (row, 32-word group) items a warp loads at once
// while packing; KW_SWEEPS sweeps of a block's rows between two grid
// barriers.
#define KW_TH 1024
#define KW_ONE 128
#define KW_ROWS 96
#define KW_SMEM (160 * 1024)
#define KW_LVL (96 * 1024)
#define KW_U 4
#define KW_SWEEPS 8

// byte i of x nonzero -> bit i (four bits)
__device__ __forceinline__ unsigned kw_bits4(unsigned x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x08102040u) >> 27;
}

__device__ __forceinline__ unsigned kw_bits16(uint4 v) {
  return kw_bits4(v.x) | (kw_bits4(v.y) << 4) | (kw_bits4(v.z) << 8) |
         (kw_bits4(v.w) << 12);
}

// word[u] = this lane's packed word (32 g[u] + lane) of bool row rows[u]
// (0 past the row, or where rows[u] < 0): vec, 16-byte loads (two a
// 32-word group, every load of the KW_U items issued first, halves joined
// by shuffles); else a byte a lane and a ballot a word
__device__ __forceinline__ void kw_words(const unsigned char* __restrict__ adj,
                                         int n, const int (&rows)[KW_U],
                                         const int (&g)[KW_U], int lane,
                                         bool vec, unsigned (&word)[KW_U]) {
  if (vec) {
    uint4 a[KW_U], b[KW_U];
#pragma unroll
    for (int u = 0; u < KW_U; ++u) {
      const long long c = 1024LL * g[u] + 16 * lane;
      const unsigned char* row = adj + (size_t)max(rows[u], 0) * n;
      const bool in = rows[u] >= 0;
      a[u] = in && c < n ? __ldcs((const uint4*)(row + c))
                         : make_uint4(0, 0, 0, 0);
      b[u] = in && c + 512 < n ? __ldcs((const uint4*)(row + c + 512))
                               : make_uint4(0, 0, 0, 0);
    }
    const int src = 2 * (lane & 15);
#pragma unroll
    for (int u = 0; u < KW_U; ++u) {
      const unsigned ma = kw_bits16(a[u]), mb = kw_bits16(b[u]);
      const unsigned wa = __shfl_sync(0xffffffffu, ma, src) |
                          (__shfl_sync(0xffffffffu, ma, src + 1) << 16);
      const unsigned wb = __shfl_sync(0xffffffffu, mb, src) |
                          (__shfl_sync(0xffffffffu, mb, src + 1) << 16);
      word[u] = lane < 16 ? wa : wb;
    }
    return;
  }
#pragma unroll 1
  for (int u = 0; u < KW_U; ++u) {
    const unsigned char* row = adj + (size_t)max(rows[u], 0) * n;
    unsigned char x[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const long long c = 32LL * (32 * g[u] + j) + lane;
      x[j] = rows[u] >= 0 && c < n ? row[c] : 0;
    }
    unsigned w = 0u;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const unsigned bal = __ballot_sync(0xffffffffu, x[j] != 0);
      if (lane == j) w = bal;
    }
    word[u] = w;
  }
}

// The round's vote and grid barrier: every block arrives with whether it
// changed a level (arrival count in the low 16 bits of flags[0], changed
// blocks in the high 16); the last to arrive resets the count and
// advances the generation by 2 if any block changed a level, else by 1,
// so the vote rides the release. *g is thread 0's view of the
// generation (read once at the start: it moves only at a barrier, which
// needs every block). One block: a block barrier. Returns whether any
// block changed a level.
__device__ __forceinline__ bool kw_vote(unsigned* flags, int changed,
                                        unsigned* g) {
  __shared__ unsigned s_any;
  const int mine = __syncthreads_or(changed);
  if (gridDim.x == 1) return mine != 0;
  if (threadIdx.x == 0) {
    volatile unsigned* gen = flags + 1;
    __threadfence();
    const unsigned add = mine ? 0x10001u : 1u;
    const unsigned got = atomicAdd(&flags[0], add) + add;
    unsigned v;
    if ((got & 0xffffu) == gridDim.x) {
      atomicExch(&flags[0], 0u);
      __threadfence();
      v = *g + ((got >> 16) ? 2u : 1u);
      atomicExch(&flags[1], v);
    } else {
      while ((v = *gen) == *g) {
      }
      __threadfence();
    }
    s_any = v - *g - 1u;
    *g = v;
  }
  __syncthreads();
  return s_any != 0u;
}

// ONE persistent cooperative launch, a block per run of rpb rows (a warp
// its rows lr = warp + 32 j). Jacobi rounds from zeros give level_r[i] =
// min(r, L(i)), L(i) the longest dependency path from i (infinite on a
// cycle), so the answer is min(max_levels, L(i)): the fixpoint of
//   level[i] = min(max_levels, max(level[i], max over i's columns j of
//                                   level[j] + 1)),
// which updates in place reach from zeros in any order (every value stays
// at or below the answer, and a sweep that changes nothing ends at it).
// Setup: a warp reads its bool rows once, the loads of KW_U (row, 32-word
// group) items issued together (16-byte loads where the rows are 16-byte
// aligned), keeps each row's columns in its share of shared memory (ecap
// entries a warp; a word's bits go out a lane a bit or a lane a word,
// whichever takes fewer steps) and sets the row's level to 1 if it has a
// column (min(max_levels, L) >= 1); a row too wide for the share is
// written packed to `packed` and read from there (L2) each sweep. A grid
// barrier (every level set) carries the vote; then phases of KW_SWEEPS
// sweeps, a barrier and its vote each, until a phase in which no level
// changed. A sweep first copies the levels from L2 into shared memory
// (other blocks write their rows meanwhile: any copy is a lower bound, the
// freshest only speeds it; beyond KW_LVL bytes each level is read from
// L2), then takes a warp's rows 4 at a time, a row's columns across the
// lanes: every level[col] of the 4 rows read at once, a warp max a row,
// then lane q writes row q's level where it rose. One block (up to
// KW_ONE rows): the levels live in shared memory only, a phase is one
// sweep and the barrier the block's. The last block to leave zeroes the
// barrier's generation and its ticket.
__global__ void __launch_bounds__(KW_TH, 1)
wavefront_kernel(const unsigned char* __restrict__ adj, int n, int nw,
                 int max_levels, unsigned* __restrict__ packed, int* out,
                 int rpb, int lvl_ints, int ecap, int vec, unsigned* flags) {
  extern __shared__ __align__(16) int kw_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * rpb;
  const int rows = min(rpb, n - r0);
  const bool single = gridDim.x == 1;
  if (max_levels == 0) {
    for (int lr = threadIdx.x; lr < rows; lr += KW_TH) out[r0 + lr] = 0;
    return;
  }
  unsigned g = 0u;   // thread 0: the barrier's generation
  if (!single && threadIdx.x == 0) g = *(volatile unsigned*)(flags + 1);
  int* s_lv = kw_smem;                    // the levels (lvl_ints > 0)
  int* s_st = kw_smem + lvl_ints;         // a row's first entry
  int* s_cnt = s_st + rpb;                // its entries (-1: read packed)
  int* s_own = s_cnt + rpb;               // its level (its writer's copy)
  int* E = s_own + rpb + warp * ecap;     // this warp's column lists
  const int ng = (nw + 31) >> 5;          // 32-word groups a row
  const int mine = rows > warp ? (rows - warp + 31) >> 5 : 0;
  const unsigned lt = (1u << lane) - 1u;
  int changed = 0;
  int used = 0, cnt = 0;                  // warp-uniform
  for (int it0 = 0; it0 < mine * ng; it0 += KW_U) {
    int rr[KW_U], gg[KW_U];
#pragma unroll
    for (int u = 0; u < KW_U; ++u) {
      const int it = it0 + u, j = it / ng;
      rr[u] = it < mine * ng ? r0 + warp + 32 * j : -1;
      gg[u] = it - j * ng;
    }
    unsigned word[KW_U];
    kw_words(adj, n, rr, gg, lane, vec != 0, word);
#pragma unroll
    for (int u = 0; u < KW_U; ++u) {
      if (rr[u] < 0) break;                 // uniform across the warp
      const int j = (it0 + u) / ng;
      const unsigned w = word[u];
      const int c = __popc(w);
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      const int tot = __shfl_sync(0xffffffffu, incl, 31);
      if (used + cnt + tot <= ecap) {
        const int base = 32 * (32 * gg[u] + lane);
        int* e = E + used + cnt + incl - c;   // this lane's word's entries
        const unsigned nz = __ballot_sync(0xffffffffu, w != 0u);
        if (__reduce_max_sync(0xffffffffu, c) <= __popc(nz)) {
          for (unsigned b = w; b; b &= b - 1u) *e++ = base + __ffs(b) - 1;
        } else {   // a lane a bit of each nonzero word in turn
          for (unsigned z = nz; z; z &= z - 1u) {
            const int s = __ffs(z) - 1;
            const unsigned ws = __shfl_sync(0xffffffffu, w, s);
            int* es = E + used + cnt + __shfl_sync(0xffffffffu, incl - c, s);
            if ((ws >> lane) & 1u)
              es[__popc(ws & lt)] = 32 * (32 * gg[u] + s) + lane;
          }
        }
      }
      cnt += tot;
      if (gg[u] < ng - 1) continue;
      // row j's last group: keep its list, or read it packed from L2
      const int lr = warp + 32 * j, i = r0 + lr;
      if (used + cnt <= ecap) {
        if (lane == 0) {
          s_st[lr] = used;
          s_cnt[lr] = cnt;
        }
        used += cnt;
      } else {
        if (lane == 0) s_cnt[lr] = -1;
        for (int q0 = 0; q0 < ng; q0 += KW_U) {
          int pr[KW_U], pg[KW_U];
          unsigned pw[KW_U];
#pragma unroll
          for (int v = 0; v < KW_U; ++v) {
            pr[v] = q0 + v < ng ? i : -1;
            pg[v] = q0 + v;
          }
          kw_words(adj, n, pr, pg, lane, vec != 0, pw);
#pragma unroll
          for (int v = 0; v < KW_U; ++v) {
            const int wi = 32 * (q0 + v) + lane;
            if (pr[v] >= 0 && wi < nw) packed[(size_t)i * nw + wi] = pw[v];
          }
        }
      }
      if (lane == 0) {
        (single ? s_lv : out)[i] = cnt > 0 ? 1 : 0;
        s_own[lr] = cnt > 0 ? 1 : 0;
        changed |= cnt > 0;
      }
      cnt = 0;
    }
  }
  __syncwarp();
  // every level is set before any is read
  if (!kw_vote(flags, changed, &g) || max_levels == 1) goto done;
  for (;;) {
    changed = 0;
    for (int sw = 0; sw < (single ? 1 : KW_SWEEPS); ++sw) {
      if (!single && lvl_ints > 0) {   // the levels' copy, refreshed
        if (sw > 0) __syncthreads();
        if ((n & 3) == 0)
          for (int v = threadIdx.x; v < (n >> 2); v += KW_TH)
            ((int4*)s_lv)[v] = __ldcg((const int4*)out + v);
        else
          for (int v = threadIdx.x; v < n; v += KW_TH)
            s_lv[v] = __ldcg(out + v);
        __syncthreads();
      }
      for (int j0 = 0; j0 < mine; j0 += 4) {
        int st[4], c[4], m[4];
        int most = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int lr = warp + 32 * (j0 + q);
          c[q] = j0 + q < mine ? s_cnt[lr] : 0;
          st[q] = c[q] > 0 ? s_st[lr] : 0;
          most = max(most, c[q]);
          m[q] = 0;
        }
        for (int k0 = 0; k0 < most; k0 += 32) {
          int col[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            col[q] = k0 + lane < c[q] ? E[st[q] + k0 + lane] : -1;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (col[q] >= 0)
              m[q] = max(m[q], (lvl_ints > 0 ? s_lv[col[q]]
                                             : __ldcg(out + col[q])) + 1);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c[q] == -1) {   // read packed: the warp walks the row
            const int i = r0 + warp + 32 * (j0 + q);
            for (int w = lane; w < nw; w += 32) {
              unsigned u = __ldcg(packed + (size_t)i * nw + w);
              for (; u; u &= u - 1u) {
                const int col = 32 * w + __ffs(u) - 1;
                m[q] = max(m[q], (lvl_ints > 0 ? s_lv[col]
                                               : __ldcg(out + col)) + 1);
              }
            }
          }
          m[q] = __reduce_max_sync(0xffffffffu, m[q]);
        }
        if (lane < 4 && j0 + lane < mine) {
          const int lr = warp + 32 * (j0 + lane);
          const int mm = lane == 0 ? m[0] : lane == 1 ? m[1]
                                          : lane == 2 ? m[2] : m[3];
          const int cur = s_own[lr];
          const int nv = min(max_levels, max(cur, mm));
          if (nv != cur) {
            s_own[lr] = nv;
            if (lvl_ints > 0) s_lv[r0 + lr] = nv;
            if (!single) out[r0 + lr] = nv;
            changed = 1;
          }
        }
      }
    }
    if (!kw_vote(flags, changed, &g)) break;
  }
done:
  if (single) {
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += KW_TH) out[i] = s_lv[i];
    return;
  }
  // every block has passed its last barrier once it takes a ticket
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&flags[2], 1u) == gridDim.x - 1u) {
      atomicExch(&flags[1], 0u);
      atomicExch(&flags[2], 0u);
    }
  }
}

// the blocks of the K20 kernel that fit on the current card at once (its
// dynamic shared memory allowed once a card)
static inline int kw_resident() {
  static int per[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& m = per[dev & 63];
  if (m <= 0) {
    cudaFuncSetAttribute(wavefront_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         KW_SMEM);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m, wavefront_kernel,
                                                  KW_TH, KW_SMEM);
  }
  return m * sm_count();
}

// adj bool[n, n] -> out i32[n]; packed scratch u32[n, ceil(n/32)] (rows
// whose columns do not fit shared memory; written before use); flags
// zeroed scratch u32[3] (the barrier's count and generation, the exit
// ticket), left zeroed. ONE cooperative launch.
extern "C" int execution_wavefronts(const void* adj, int n, int max_levels,
                                    void* packed, void* out, void* flags,
                                    void* stream) {
  if (n <= 0) return 0;
  if (max_levels < 0 || flags == nullptr) return (int)cudaErrorInvalidValue;
  int nw = (n + 31) / 32;
  int grid = kw_resident();
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  const int want = n <= KW_ONE ? 1 : (n + KW_ROWS - 1) / KW_ROWS;
  if (want < grid) grid = want;
  int rpb = (n + grid - 1) / grid;
  grid = (n + rpb - 1) / rpb;
  int lvl_ints = grid == 1 || 4LL * n <= KW_LVL ? (n + 3) & ~3 : 0;
  int ecap = (int)(((long long)KW_SMEM / 4 - lvl_ints - 3LL * rpb) / 32);
  if (ecap < 0) return (int)cudaErrorInvalidConfiguration;
  int vec = n % 16 == 0 && ((uintptr_t)adj & 15u) == 0;
  const unsigned char* a = (const unsigned char*)adj;
  unsigned* p = (unsigned*)packed;
  int* o = (int*)out;
  unsigned* fl = (unsigned*)flags;
  void* args[] = {&a,   &n,        &nw,   &max_levels, &p,   &o,
                  &rpb, &lvl_ints, &ecap, &vec,        &fl};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)wavefront_kernel, grid, KW_TH, args, KW_SMEM,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// ---------------------------------------------------------------- K21
#define DW_TH 1024  // threads a block (32 warps), a block an SM
#define DW_K 16    // words a lane loads a scan step (32 * DW_K a warp)
#define DW_C 64    // blocking words a row keeps (index, value)
#define DW_B 4     // kept words a lane tests at once
#define DW_R 32    // rows a lane owns at most
// the zeroed scratch (ops/kernels.py _DAG_FLAG_BYTES): the grid barrier's
// arrival count and generation, the exit ticket
#define DW_FLAGS 3

// The grid barrier of a cooperative launch (its blocks all resident):
// each block arrives once; the last to arrive resets the count and
// advances the generation, which the others wait on. The count is zero
// again after every barrier; the generation may hold any value on entry.
__device__ __forceinline__ void dw_barrier(unsigned* flags) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = flags + 1;
    const unsigned g = *gen;
    __threadfence();
    if (atomicAdd(&flags[0], 1u) == gridDim.x - 1u) {
      atomicExch(&flags[0], 0u);
      __threadfence();
      atomicAdd(&flags[1], 1u);
    } else {
      while (*gen == g) {
      }
    }
    __threadfence();
  }
  __syncthreads();
}

// The words at and after `start` of `row` that block now (a bit outside
// `app`), in order: the first DW_C go to `cache` as (index, value), the
// first also to *head, their count to *count; returns the index of the
// next blocking word past them,
// or nw when there is none (the whole warp; `app` is read only where the
// row's word is nonzero). A word that does not block now never will:
// applied only grows.
__device__ __forceinline__ int dw_collect(const unsigned* __restrict__ row,
                                          const unsigned* app, int start,
                                          int nw, int lane, uint2* cache,
                                          uint2* head, int* count) {
  int cnt = 0;
  for (int base = start; base < nw; base += 32 * DW_K) {
    unsigned x[DW_K];
#pragma unroll
    for (int j = 0; j < DW_K; ++j) {
      const int w = base + 32 * j + lane;
      x[j] = w < nw ? __ldg(row + w) : 0u;
    }
#pragma unroll
    for (int j = 0; j < DW_K; ++j)
      if (x[j]) x[j] &= ~__ldcg(app + base + 32 * j + lane);
#pragma unroll
    for (int j = 0; j < DW_K; ++j) {
      const unsigned bal = __ballot_sync(0xffffffffu, x[j] != 0u);
      if (!bal) continue;
      const int pos = cnt + __popc(bal & ((1u << lane) - 1u));
      const int w = base + 32 * j + lane;
      if (x[j] && pos < DW_C) __stcg(cache + pos, make_uint2(w, x[j]));
      if (x[j] && pos == 0) __stcg(head, make_uint2(w, x[j]));
      cnt += __popc(bal);
      if (cnt > DW_C) {
        const unsigned at = __ballot_sync(0xffffffffu, x[j] && pos == DW_C);
        *count = DW_C;
        return base + 32 * j + __ffs(at) - 1;
      }
    }
  }
  *count = cnt;
  return nw;
}

// ONE launch settles every round: rounds r = 0 .. max_levels - 1 with a
// grid barrier after each, until a round settles nothing (every later
// round would be a no-op: applied stops changing) or every row settled.
// A lane owns the rows k * 32 W + lane * W + warp (W warps in the grid,
// k < DW_R), so a warp's rows lie far apart, and keeps which of them are
// unsettled in a register: a round visits only those. A row keeps the
// words that blocked it when it was last read -- up to DW_C of them,
// (index, value), from the first -- with `ptr` its first one not yet
// cleared, `head` that word, and `gnx` where its unread words resume (nw:
// none). In round 0 a warp reads each of its rows from word 0 and keeps
// its blocking words; a row with none settles. Later the owner lane tests
// the row's head against applied: a row still blocked costs that one
// test; else the lane walks the next kept words, DW_B at a time with their
// loads issued together, and a row whose kept words all cleared settles if
// nothing is left unread, else the warp reads on from gnx and keeps the
// next blocking words (none: the row settles). So each word of the
// adjacency (1.25 GB at N = 100,000) is read about once in all, and a
// round after the first reads a live row's head and applied word.
// Settling: level r, the row's bit into the next round's applied, counted
// by the block in shared memory and added to rc[r] at the barrier. Jacobi:
// round r reads applied app[r & 1] (the rows of rounds < r) and writes
// app[(r + 1) & 1], which held rounds < r - 1 and first takes app[r &
// 1]'s bits. Everything but the barrier's count and the exit ticket is
// rebuilt before use; the last block to leave zeroes the flags.
__global__ void __launch_bounds__(DW_TH, 1)
dag_settle_kernel(const unsigned* __restrict__ adj, int n, int nw,
                  int max_levels, int* __restrict__ level, uint2* cache,
                  uint2* head, int* ptr, int* cnt, int* gnx, unsigned* app0,
                  unsigned* app1, int* rc, unsigned* flags) {
  __shared__ int s_set;  // the block's settles this round
  const long long nth = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = threadIdx.x & 31;
  if (max_levels == 0) {
    for (long long i = tid; i < n; i += nth) level[i] = -1;
    return;
  }
  for (long long w = tid; w < nw; w += nth) {
    app0[w] = 0u;
    app1[w] = 0u;
  }
  for (long long q = tid; q < max_levels; q += nth) rc[q] = 0;
  if (threadIdx.x == 0) s_set = 0;
  dw_barrier(flags);
  const long long nwarps = nth >> 5;
  const long long mine = (long long)lane * nwarps + (tid >> 5);
  const int rows = (int)((n + 32 * nwarps - 1) / (32 * nwarps));
  unsigned live = 0u;  // bit k: the lane's row k is unsettled
  long long done = 0;  // rows settled so far
  for (int r = 0; r < max_levels; ++r) {
    const unsigned* cur = (r & 1) ? app1 : app0;
    unsigned* nxt = (r & 1) ? app0 : app1;
    if (r > 0)
      for (long long w = tid; w < nw; w += nth) {
        const unsigned v = __ldcg(cur + w);
        if (v & ~__ldcg(nxt + w)) atomicOr(nxt + w, v);
      }
    int settled = 0;
    for (int k = 0; k < rows; ++k) {  // uniform across the warp
      const long long p = (long long)k * 32 * nwarps + mine;
      const int i = (int)p;
      int start = 0;
      int how = 0;  // 1 blocked, 2 settles, 3 to read on from `start`
      if (p < n && (r == 0 || ((live >> k) & 1u))) {
        if (r == 0) {
          how = 3;
        } else {
          const uint2 h = __ldcg(head + i);
          how = (h.y & ~__ldcg(cur + h.x)) ? 1 : 0;
        }
        if (how == 0) {  // the head cleared: the next kept words
          const int c = __ldcg(cnt + i);
          const uint2* ci = cache + (size_t)i * DW_C;
          int q = __ldcg(ptr + i) + 1;
          uint2 hn = make_uint2(0u, 0u);
          while (q < c) {
            uint2 e[DW_B];
            unsigned a[DW_B];
#pragma unroll
            for (int j = 0; j < DW_B; ++j)
              e[j] = q + j < c ? __ldcg(ci + q + j) : make_uint2(0u, 0u);
#pragma unroll
            for (int j = 0; j < DW_B; ++j)
              a[j] = q + j < c ? __ldcg(cur + e[j].x) : 0u;
            int f = DW_B;
#pragma unroll
            for (int j = DW_B - 1; j >= 0; --j)
              if (e[j].y & ~a[j]) {
                f = j;
                hn = e[j];
              }
            if (f < DW_B) {
              q += f;
              break;
            }
            q = min(q + DW_B, c);
          }
          if (q < c) {
            how = 1;
            __stcg(ptr + i, q);
            __stcg(head + i, hn);
          } else {
            start = __ldcg(gnx + i);
            how = start < nw ? 3 : 2;
          }
        }
      }
      unsigned todo = __ballot_sync(0xffffffffu, how == 3);
      while (todo) {
        const int l = __ffs(todo) - 1;
        todo &= todo - 1u;
        const int ri = __shfl_sync(0xffffffffu, i, l);
        const int st = __shfl_sync(0xffffffffu, start, l);
        int got = 0;
        const int g = dw_collect(adj + (size_t)ri * nw, cur, st, nw, lane,
                                 cache + (size_t)ri * DW_C, head + ri, &got);
        if (lane == l) {
          how = got > 0 ? 1 : 2;
          if (got > 0) {
            __stcg(ptr + ri, 0);
            __stcg(cnt + ri, got);
            __stcg(gnx + ri, g);
          }
        }
      }
      if (how == 1) {
        live |= 1u << k;
        if (r == 0) level[i] = -1;
      } else if (how == 2) {
        live &= ~(1u << k);
        level[i] = r;
        atomicOr(nxt + (i >> 5), 1u << (i & 31));
        ++settled;
      }
    }
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      settled += __shfl_xor_sync(0xffffffffu, settled, d);
    if (lane == 0 && settled) atomicAdd(&s_set, settled);
    __syncthreads();
    if (threadIdx.x == 0 && s_set) {
      atomicAdd(&rc[r], s_set);
      s_set = 0;
    }
    dw_barrier(flags);
    const int got = __ldcg(&rc[r]);
    done += got;
    if (got == 0 || done == n) break;
  }
  // every block has passed its last barrier once it takes a ticket
  if (threadIdx.x == 0) {
    __threadfence();
    if (atomicAdd(&flags[2], 1u) == gridDim.x - 1u) {
      atomicExch(&flags[1], 0u);
      atomicExch(&flags[2], 0u);
    }
  }
}

// the blocks of the settle kernel that fit on the current card at once
static inline int dw_resident() {
  static int per[64];
  int dev = 0;
  cudaGetDevice(&dev);
  int& m = per[dev & 63];
  if (m <= 0)
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&m, dag_settle_kernel,
                                                  DW_TH, 0);
  return m * sm_count();
}

// the int32 scratch dag_wavefronts_packed takes (`buf`): the kept words
// (2 DW_C a row, first) and the heads (2 a row), ptr, cnt and gnx (n
// each), two applied sets (nw each), the round counts (max_levels)
extern "C" long long dag_buf_ints(int n, int max_levels) {
  return 2LL * (DW_C + 1) * n + 3LL * n + 2LL * ((n + 31) / 32) +
         (max_levels > 0 ? max_levels : 0);
}

// adj_packed [n, nw] (n == 32 * nw) -> level i32[n]; buf dag_buf_ints(n,
// max_levels) i32 scratch, 8-byte aligned (all written before use); flags
// zeroed scratch [DW_FLAGS], left zeroed; max_blocks caps the grid (0:
// every block the card holds at once; fewer give each lane more rows).
// ONE cooperative launch (none when n is 0), whatever the data: the
// runtime places every block at once or returns an error, so the grid
// barrier cannot wait on a block that never runs.
extern "C" int dag_wavefronts_packed(const void* adj, int n, int nw,
                                     int max_levels, void* level, void* buf,
                                     void* flags, int max_blocks,
                                     void* stream) {
  if (n <= 0) return 0;
  if (n != 32 * nw || max_levels < 0 || flags == nullptr || max_blocks < 0 ||
      ((uintptr_t)buf & 7u))
    return (int)cudaErrorInvalidValue;
  int grid = dw_resident();
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  if (max_blocks > 0 && max_blocks < grid) grid = max_blocks;
  // at least two rows a warp where the rows are few
  const long long want = ((long long)n + 2 * (DW_TH / 32) - 1) /
                         (2 * (DW_TH / 32));
  if (want < grid) grid = (int)want;
  // a lane owns at most DW_R rows (its unsettled ones are a register's
  // bits): never short at N the card can hold on the whole grid
  if ((n + (long long)DW_TH * grid - 1) / ((long long)DW_TH * grid) > DW_R)
    return (int)cudaErrorInvalidConfiguration;
  const unsigned* a = (const unsigned*)adj;
  int* lv = (int*)level;
  uint2* cache = (uint2*)buf;
  uint2* head = cache + (size_t)DW_C * n;
  int* ptr = (int*)buf + 2LL * (DW_C + 1) * n;
  int* cnt = ptr + n;
  int* gnx = ptr + 2LL * n;
  unsigned* app0 = (unsigned*)(ptr + 3LL * n);
  unsigned* app1 = app0 + nw;
  int* rc = (int*)(app1 + nw);
  unsigned* fl = (unsigned*)flags;
  void* args[] = {&a,    &n,   &nw,  &max_levels, &lv,   &cache, &head,
                  &ptr,  &cnt, &gnx, &app0,       &app1, &rc,    &fl};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)dag_settle_kernel, grid, DW_TH, args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}
