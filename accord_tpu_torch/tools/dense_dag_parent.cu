// The parent's K18 deps_matrix and K19 transitive_closure (before their
// Hopper redesign in csrc/dense_dag.cu), and the parent's K21
// dag_wavefronts_packed (before its redesign), kept as the baseline that
// `python -m accord_tpu_torch.tools.dense_dag_variants` (and chip_smoke.py)
// times beside the shipped kernels. Built only by those (nvcc -I csrc),
// never by the port's build and never on a path. K18's and K19's C entry
// points keep the old signatures: transitive_closure takes no flags
// scratch, and N is capped at 32 x closure_max_words(). K21's has the
// shipped signature, so it binds in place of the shipped entry.
//
// K18: a block computes a 64 x 64 tile (16 outputs a thread), streaming
// 32-word chunks of both operands through shared memory.
// K19: a block takes 8 rows and, for each set bit k of their words, reads
// row k's word from global memory.
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
                   int kw, int sws, int aws, unsigned char* __restrict__ out) {
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
        if (b0 + r < B) vs = sw[(long long)(b0 + r) * sws + k0 + w];
        if (a0 + r < A) va = aw[(long long)(a0 + r) * aws + k0 + w];
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

// sw's and aw's rows start sws and aws words apart (kw of them used)
extern "C" int deps_matrix_strided(const void* sw, int sws, const void* sb,
                                   const void* sk, const void* aw, int aws,
                                   const void* at, const void* ak,
                                   const void* av, const void* wt, int nk0,
                                   int nk1, int B, int A, int kw, void* out,
                                   void* stream) {
  if (B <= 0 || A <= 0) return 0;
  if (nk0 <= 0 || nk1 <= 0 || sws < kw || aws < kw)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((A + DT - 1) / DT, (B + DT - 1) / DT);
  deps_matrix_kernel<<<grid, DTH, 0, st>>>(
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
#define CRB 8      // rows a block squares at once
#define CTH 256

// rows [row0, row0 + nrows) of one squaring of the full packed r [n, nw],
// written to rn[(i - row0) * nw ...]
__global__ void __launch_bounds__(CTH)
closure_square_kernel(const unsigned* __restrict__ r,
                      unsigned* __restrict__ rn, int n, int nw, int row0,
                      int nrows) {
  extern __shared__ unsigned s_rows[];  // CRB x nw
  const int i0 = row0 + blockIdx.x * CRB;
  const int iend = row0 + nrows;
  for (int e = threadIdx.x; e < CRB * nw; e += CTH) {
    const int q = e / nw, w = e % nw;
    s_rows[e] = i0 + q < iend ? r[(long long)(i0 + q) * nw + w] : 0u;
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
        if (i0 + q < iend)
          rn[(long long)(i0 + q - row0) * nw + w] = s_rows[q * nw + w] | acc[q];
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
  launch_pack((const unsigned char*)adj, n, n, nw, cur, st);
  ACCORD_CHECK();
  const size_t smem = sizeof(unsigned) * CRB * nw;
  for (int it = 0; it < iterations; ++it) {
    closure_square_kernel<<<(n + CRB - 1) / CRB, CTH, smem, st>>>(cur, nxt, n,
                                                                  nw, 0, n);
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

// rows [row0, row0 + nrows) of one closure squaring: full r [n, nw] on the
// device, the block's rows written to rn [nrows, nw]
extern "C" int closure_rows(const void* r, int n, int row0, int nrows,
                            void* rn, void* stream) {
  if (n <= 0 || nrows <= 0) return 0;
  const int nw = (n + 31) / 32;
  if (nw > closure_max_words() || row0 < 0 || row0 + nrows > n)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(unsigned) * CRB * nw;
  closure_square_kernel<<<(nrows + CRB - 1) / CRB, CTH, smem,
                          (cudaStream_t)stream>>>(
      (const unsigned*)r, (unsigned*)rn, n, nw, row0, nrows);
  ACCORD_CHECK();
  return 0;
}


// The parent's K21: 2 x max_levels + 3 stream operations, a
// copy of applied and a round launch over every row each round.
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

// the shipped signature (csrc/dense_dag.cu): buf i32[3n + 2nw + ...] holds
// the parent's resume (first n) and its two applied sets (from 3n); the
// flags scratch and the grid cap are not used
extern "C" int dag_wavefronts_packed(const void* adj, int n, int nw,
                                     int max_levels, void* level, void* buf,
                                     void* flags, int max_blocks,
                                     void* stream) {
  if (n <= 0) return 0;
  if (n != 32 * nw || max_levels < 0) return (int)cudaErrorInvalidValue;
  (void)flags;
  (void)max_blocks;
  cudaStream_t st = (cudaStream_t)stream;
  int* resume = (int*)buf;
  unsigned* app_a = (unsigned*)((int*)buf + 3LL * n);
  unsigned* app_b = app_a + nw;
  fill_kernel<<<grid_for(n, 256), 256, 0, st>>>((int*)level, n, -1);
  ACCORD_CHECK();
  cudaMemsetAsync(app_a, 0, sizeof(unsigned) * (size_t)nw, st);
  cudaMemsetAsync(resume, 0, sizeof(int) * (size_t)n, st);
  unsigned* cur = app_a;
  unsigned* nxt = app_b;
  const int grid = grid_cap(n, 8);
  for (int r = 0; r < max_levels; ++r) {
    launch_copy(nxt, (const unsigned*)cur, nw, st);
    dag_round_kernel<<<grid, 256, 0, st>>>((const unsigned*)adj, cur, nxt,
                                           (int*)level, resume, n, nw, r);
    ACCORD_CHECK();
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}
