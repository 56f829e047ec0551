// K18-K21: the execute-DAG kernels over dense and packed boolean matrices.
//
// Packed rows are 32-bit words, column 32*w + i in bit i of word w, as
// everywhere in the port (common.cuh).
//
// K18 deps_matrix -- replaces accord_tpu/ops/kernels.py `deps_matrix` (:36).
//   dep[b, a] = overlap(b, a) & witness[kind_b, kind_a] == 1
//               & act_ts[a] <lex subj_before[b] & act_valid[a]
//   The reference's overlap is a bf16 matmul of 0/1 bitmaps > 0.5; here the
//   bitmaps arrive packed (i32[., K/32]) and the overlap is "any word of
//   subj & act is nonzero", which is exact. A block computes a 64 x 64 tile
//   (16 outputs a thread), streaming 32-word chunks of both operands through
//   shared memory; the tile's bytes go out through shared memory as rows.
//   Bound: operations, B*A*K/32 word ANDs (2.1 G at B 4,096, A 16,384,
//   K 1,024: ~0.03 ms at 67 T op/s); the bool output (67 MB) is ~0.02 ms.
//
// K19 transitive_closure -- replaces `transitive_closure` (:97):
//   R |= (R @ R > 0.5), exactly `iterations` times (Jacobi: each squaring
//   reads the previous R, writes a second buffer). On packed rows, R @ R's
//   row i is the OR of the rows k with R[i, k] set; a block takes 8 rows at
//   once, so each row k it loads serves all of them. The bool[N, N] input
//   is packed first and the result unpacked last. Bound: operations, the
//   word ORs this data needs (sum over iterations of set bits x N/32).
//
// K20 execution_wavefronts -- replaces `execution_wavefronts` (:113):
//   level'[i] = max(level[i], max_j adj[i, j] * (level[j] + 1)), from
//   zeros, `max_levels` rounds, double-buffered (one launch a round reads
//   the previous round's levels). A warp takes a row of the packed matrix.
//
// K21 dag_wavefronts_packed -- replaces `dag_wavefronts_packed` (:197):
//   per round r: blocked[i] = any_w(adj[i, w] & ~applied[w]); ready =
//   !blocked & level < 0; level[i] = r for ready rows, whose bits OR into
//   the NEXT round's applied (a copy of this round's, so the round reads
//   only the previous one: Jacobi). A warp scans a row 32 words at a time
//   and stops at the first blocking word, which it keeps: applied only
//   grows, so the words before it stay clear and the next round resumes
//   there. Settled rows are skipped. So the adjacency (1.25 GB at N =
//   100,000) is read about once in all, not once a round. Bound: bytes,
//   the adjacency read once (~0.37 ms at 3.35 TB/s).
#include "common.cuh"

// ---------------------------------------------------------------- K18
#define DT 64   // tile: subjects x actives
#define DKW 32  // words per streamed chunk
#define DTH 256

__global__ void __launch_bounds__(DTH)
deps_matrix_kernel(const unsigned* __restrict__ sw, const int* __restrict__ sb,
                   const int* __restrict__ sk, const unsigned* __restrict__ aw,
                   const int* __restrict__ at, const int* __restrict__ ak,
                   const unsigned char* __restrict__ av,
                   const int* __restrict__ wt, int nk0, int nk1, int B, int A,
                   int kw, unsigned char* __restrict__ out) {
  // [word][row], padded so a row of the tile spreads over the banks
  __shared__ unsigned s_s[DKW][DT + 1];
  __shared__ unsigned s_a[DKW][DT + 1];
  __shared__ __align__(16) unsigned char s_out[DT][DT];
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b0 = blockIdx.y * DT, a0 = blockIdx.x * DT;
  unsigned acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  for (int k0 = 0; k0 < kw; k0 += DKW) {
    const int kn = min(DKW, kw - k0);
    for (int e = threadIdx.x; e < DT * DKW; e += DTH) {
      const int r = e / DKW, w = e % DKW;
      unsigned vs = 0, va = 0;
      if (w < kn) {
        if (b0 + r < B) vs = sw[(long long)(b0 + r) * kw + k0 + w];
        if (a0 + r < A) va = aw[(long long)(a0 + r) * kw + k0 + w];
      }
      s_s[w][r] = vs;
      s_a[w][r] = va;
    }
    __syncthreads();
    for (int w = 0; w < kn; ++w) {
      unsigned s[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i] = s_s[w][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = s_a[w][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] |= s[i] & a[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = b0 + ty * 4 + i;
    const bool brow = b < B;
    int s0 = 0, s1 = 0, s2 = 0, skind = 0;
    if (brow) {
      s0 = sb[3LL * b];
      s1 = sb[3LL * b + 1];
      s2 = sb[3LL * b + 2];
      int k = sk[b];
      if (k < 0) k += nk0;
      skind = k < 0 ? 0 : (k >= nk0 ? nk0 - 1 : k);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int a = a0 + tx + 16 * j;
      bool d = false;
      if (brow && a < A && acc[i][j] != 0 && av[a]) {
        int k = ak[a];
        if (k < 0) k += nk1;
        k = k < 0 ? 0 : (k >= nk1 ? nk1 - 1 : k);
        d = wt[skind * nk1 + k] == 1 &&
            lex_before(at[3LL * a], at[3LL * a + 1], at[3LL * a + 2], s0, s1,
                       s2);
      }
      s_out[ty * 4 + i][tx + 16 * j] = d ? 1 : 0;
    }
  }
  __syncthreads();
  const bool vec = (A & 3) == 0 && a0 + DT <= A &&
                   (((uintptr_t)out) & 3u) == 0;
  if (vec) {
    for (int e = threadIdx.x; e < DT * (DT / 4); e += DTH) {
      const int r = e / (DT / 4), c = e % (DT / 4);
      if (b0 + r < B)
        *(unsigned*)(out + (long long)(b0 + r) * A + a0 + 4 * c) =
            *(const unsigned*)(&s_out[r][4 * c]);
    }
  } else {
    for (int e = threadIdx.x; e < DT * DT; e += DTH) {
      const int r = e / DT, c = e % DT;
      if (b0 + r < B && a0 + c < A)
        out[(long long)(b0 + r) * A + a0 + c] = s_out[r][c];
    }
  }
}

extern "C" int deps_matrix(const void* sw, const void* sb, const void* sk,
                           const void* aw, const void* at, const void* ak,
                           const void* av, const void* wt, int nk0, int nk1,
                           int B, int A, int kw, void* out, void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (nk0 <= 0 || nk1 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((A + DT - 1) / DT, (B + DT - 1) / DT);
  deps_matrix_kernel<<<grid, DTH, 0, st>>>(
      (const unsigned*)sw, (const int*)sb, (const int*)sk,
      (const unsigned*)aw, (const int*)at, (const int*)ak,
      (const unsigned char*)av, (const int*)wt, nk0, nk1, B, A, kw,
      (unsigned char*)out);
  ACCORD_CHECK();
  return 0;
}

// ------------------------------------------------- packing (K19, K20)
// bool[n, n] -> packed [n, nw]: a warp packs 32 columns of a row (ballot)
__global__ void pack_rows_kernel(const unsigned char* __restrict__ m, int n,
                                 int nw, unsigned* __restrict__ p) {
  const long long total = (long long)n * nw;
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

__global__ void unpack_rows_kernel(const unsigned* __restrict__ p, int n,
                                   int nw, unsigned char* __restrict__ m) {
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

static inline void launch_pack(const unsigned char* m, int n, int nw,
                               unsigned* p, cudaStream_t st) {
  pack_rows_kernel<<<grid_cap((long long)n * nw, 8), 256, 0, st>>>(m, n, nw,
                                                                   p);
}

// ---------------------------------------------------------------- K19
#define CRB 8      // rows a block squares at once
#define CTH 256

__global__ void __launch_bounds__(CTH)
closure_square_kernel(const unsigned* __restrict__ r,
                      unsigned* __restrict__ rn, int n, int nw) {
  extern __shared__ unsigned s_rows[];  // CRB x nw
  const int i0 = blockIdx.x * CRB;
  for (int e = threadIdx.x; e < CRB * nw; e += CTH) {
    const int q = e / nw, w = e % nw;
    s_rows[e] = i0 + q < n ? r[(long long)(i0 + q) * nw + w] : 0u;
  }
  __syncthreads();
  for (int w0 = 0; w0 < nw; w0 += CTH) {
    const int w = w0 + threadIdx.x;
    unsigned acc[CRB];
#pragma unroll
    for (int q = 0; q < CRB; ++q) acc[q] = 0;
    for (int kw = 0; kw < nw; ++kw) {
      unsigned bits[CRB];
      unsigned u = 0;
#pragma unroll
      for (int q = 0; q < CRB; ++q) {
        bits[q] = s_rows[q * nw + kw];
        u |= bits[q];
      }
      while (u) {
        const int b = __ffs(u) - 1;
        u &= u - 1;
        const long long k = (long long)kw * 32 + b;
        const unsigned v = w < nw ? r[k * nw + w] : 0u;
#pragma unroll
        for (int q = 0; q < CRB; ++q)
          if ((bits[q] >> b) & 1u) acc[q] |= v;
      }
    }
    if (w < nw)
#pragma unroll
      for (int q = 0; q < CRB; ++q)
        if (i0 + q < n)
          rn[(long long)(i0 + q) * nw + w] = s_rows[q * nw + w] | acc[q];
  }
}

extern "C" int closure_max_words() { return (48 * 1024) / (4 * CRB); }

// adj bool[n, n] -> out bool[n, n]; pa, pb packed scratch [n, nw]
extern "C" int transitive_closure(const void* adj, int n, int iterations,
                                  void* pa, void* pb, void* out,
                                  void* stream) {
  if (n <= 0) return 0;
  const int nw = (n + 31) / 32;
  if (nw > closure_max_words() || iterations < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* cur = (unsigned*)pa;
  unsigned* nxt = (unsigned*)pb;
  launch_pack((const unsigned char*)adj, n, nw, cur, st);
  ACCORD_CHECK();
  const size_t smem = sizeof(unsigned) * CRB * nw;
  for (int it = 0; it < iterations; ++it) {
    closure_square_kernel<<<(n + CRB - 1) / CRB, CTH, smem, st>>>(cur, nxt, n,
                                                                  nw);
    ACCORD_CHECK();
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }
  unpack_rows_kernel<<<grid_for((long long)n * n, 256), 256, 0, st>>>(
      cur, n, nw, (unsigned char*)out);
  ACCORD_CHECK();
  return 0;
}

// ---------------------------------------------------------------- K20
__global__ void wavefront_round_kernel(const unsigned* __restrict__ p,
                                       const int* __restrict__ lvl,
                                       int* __restrict__ lvl_out, int n,
                                       int nw) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < n;
       i += warps) {
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
    if (lane == 0) lvl_out[i] = max(lvl[i], m);
  }
}

// adj bool[n, n] -> out i32[n]; packed scratch [n, nw]; lb scratch i32[n]
extern "C" int execution_wavefronts(const void* adj, int n, int max_levels,
                                    void* packed, void* out, void* lb,
                                    void* stream) {
  if (n <= 0) return 0;
  if (max_levels < 0) return (int)cudaErrorInvalidValue;
  const int nw = (n + 31) / 32;
  cudaStream_t st = (cudaStream_t)stream;
  launch_pack((const unsigned char*)adj, n, nw, (unsigned*)packed, st);
  ACCORD_CHECK();
  int* cur = (int*)out;
  int* nxt = (int*)lb;
  cudaMemsetAsync(cur, 0, sizeof(int) * (size_t)n, st);
  const int grid = grid_cap(n, 8);
  for (int r = 0; r < max_levels; ++r) {
    wavefront_round_kernel<<<grid, 256, 0, st>>>((const unsigned*)packed,
                                                 cur, nxt, n, nw);
    ACCORD_CHECK();
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (cur != (int*)out) launch_copy((int*)out, (const int*)cur, n, st);
  ACCORD_CHECK();
  return 0;
}

// ---------------------------------------------------------------- K21
__global__ void dag_round_kernel(const unsigned* __restrict__ p,
                                 const unsigned* __restrict__ app,
                                 unsigned* __restrict__ app_nxt,
                                 int* __restrict__ level,
                                 int* __restrict__ resume, int n, int nw,
                                 int round) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  for (int i = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5); i < n;
       i += warps) {
    if (level[i] >= 0) continue;  // settled (the whole warp reads it)
    const unsigned* row = p + (long long)i * nw;
    int first = -1;
    for (int base = resume[i]; base < nw; base += 32) {
      const int w = base + lane;
      const bool blk = w < nw && (row[w] & ~app[w]) != 0u;
      const unsigned bal = __ballot_sync(0xffffffffu, blk);
      if (bal) {
        first = base + __ffs(bal) - 1;
        break;
      }
    }
    if (lane == 0) {
      if (first >= 0) {
        resume[i] = first;
      } else {
        level[i] = round;
        atomicOr(app_nxt + (i >> 5), 1u << (i & 31));
      }
    }
  }
}

__global__ void fill_kernel(int* __restrict__ x, int n, int v) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    x[i] = v;
}

// adj_packed [n, nw] (n == 32 * nw) -> level i32[n]; app_a, app_b scratch
// [nw]; resume scratch i32[n]
extern "C" int dag_wavefronts_packed(const void* adj, int n, int nw,
                                     int max_levels, void* level, void* app_a,
                                     void* app_b, void* resume,
                                     void* stream) {
  if (n <= 0) return 0;
  if (n != 32 * nw || max_levels < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  fill_kernel<<<grid_for(n, 256), 256, 0, st>>>((int*)level, n, -1);
  ACCORD_CHECK();
  cudaMemsetAsync(app_a, 0, sizeof(unsigned) * (size_t)nw, st);
  cudaMemsetAsync(resume, 0, sizeof(int) * (size_t)n, st);
  unsigned* cur = (unsigned*)app_a;
  unsigned* nxt = (unsigned*)app_b;
  const int grid = grid_cap(n, 8);
  for (int r = 0; r < max_levels; ++r) {
    launch_copy(nxt, (const unsigned*)cur, nw, st);
    dag_round_kernel<<<grid, 256, 0, st>>>((const unsigned*)adj, cur, nxt,
                                           (int*)level, (int*)resume, n, nw,
                                           r);
    ACCORD_CHECK();
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}
