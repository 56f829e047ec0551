// K18 deps_matrix on the CUDA cores: the register-tiled form that the
// Hopper redesign timed against its tensor-core form (csrc/dense_dag.cu,
// `mma.sync...b1.and.popc`) and lost to. Kept as a variant that
// `python -m accord_tpu_torch.tools.dense_dag_variants` times beside the
// shipped kernel. Built only by that tool (nvcc -I csrc), never by the
// port's build and never on a path. Same C entries and contract as the
// shipped deps_matrix and deps_matrix_strided.
//
// A block takes 64 subjects x 256 actives; a warp holds 8 subjects (the
// same for all its lanes), a lane 8 actives: 8 x 8 accumulators a thread.
// 16-word chunks stream word-major ([word][row]) by 4-byte cp.async,
// double-buffered; a ballot gives each subject row's nonzero words and
// the warp walks only those, two 16-byte loads of the lane's 8 active
// words each (bucket bitmaps of a few keys leave most words zero).
#include "common.cuh"

// 4-byte asynchronous copy global -> shared; `ok` false fills zeros
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// every group but the newest `n` complete
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n));
}

// gather rules of the reference's witness lookup: a negative kind counts
// from the end, then clamps into [0, nk)
__device__ __forceinline__ int kind_index(int k, int nk) {
  if (k < 0) k += nk;
  return k < 0 ? 0 : (k >= nk ? nk - 1 : k);
}

#define DM_KC 16  // words a staged chunk
#define DM_TH 256
#define DM_SR 8                   // subjects a warp holds
#define DM_TB (DM_SR * DM_TH / 32)  // 64 subjects a tile
#define DM_TA 256                 // actives a tile: 32 lanes x 8
#define DM_PS (DM_TB + 4)         // [word][row] pitches, 4 mod 32: a
#define DM_PA (DM_TA + 4)         // copy's 4 rows x 8 words on 32 banks
#define DM_STAGE (DM_KC * (DM_PS + DM_PA))

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

// chunk [k0, k0 + DM_KC) of the tile's rows, word-major [word][row]
// (zeros past an edge); a warp copies 4 rows x 8 words
template <int ROWS, int PITCH>
__device__ __forceinline__ void dm_load_rows(unsigned* dst,
                                             const unsigned* __restrict__ src,
                                             int n, int kw, int stride,
                                             int r0, int k0) {
  for (int e = threadIdx.x; e < ROWS * DM_KC; e += DM_TH) {
    const int wl = e & 7, rest = e >> 3;
    const int r = rest % ROWS, w = (rest / ROWS) * 8 + wl;
    const bool ok = r0 + r < n && k0 + w < kw;
    cp_async4(dst + w * PITCH + r,
              ok ? src + (long long)(r0 + r) * stride + k0 + w : src, ok);
  }
}

__global__ void __launch_bounds__(DM_TH)
deps_matrix_kernel(const unsigned* __restrict__ sw, const int* __restrict__ sb,
                   const int* __restrict__ sk, const unsigned* __restrict__ aw,
                   const int* __restrict__ at, const int* __restrict__ ak,
                   const unsigned char* __restrict__ av,
                   const int* __restrict__ wt, int nk0, int nk1, int B, int A,
                   int kw, int sws, int aws, unsigned char* __restrict__ out) {
  __shared__ __align__(16) DmSmem sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = blockIdx.y * DM_TB, a0 = blockIdx.x * DM_TA;
  unsigned acc[DM_SR][8];
#pragma unroll
  for (int i = 0; i < DM_SR; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0;
  const int nch = (kw + DM_KC - 1) / DM_KC;
  auto load = [&](int st, int k0) {
    dm_load_rows<DM_TB, DM_PS>(sm.stage[st], sw, B, kw, sws, b0, k0);
    dm_load_rows<DM_TA, DM_PA>(sm.stage[st] + DM_KC * DM_PS, aw, A, kw, aws,
                               a0, k0);
  };
  if (nch > 0) load(0, 0);
  cp_async_commit();
  // the epilogue's lanes load while the first chunk is in flight
  dm_stage_lanes(sm.lanes, sb, sk, at, ak, av, nk0, nk1, B, A, b0, a0);
  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) load((c + 1) & 1, (c + 1) * DM_KC);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const unsigned* S = sm.stage[c & 1] + warp * DM_SR;
    const unsigned* T = sm.stage[c & 1] + DM_KC * DM_PS + 4 * lane;
    const int kn = min(DM_KC, kw - c * DM_KC);
    // lane w holds word w of the warp's 8 subject rows; a ballot gives
    // each row's nonzero words (uniform over the warp)
    uint4 s0 = make_uint4(0u, 0u, 0u, 0u), s1 = s0;
    if (lane < kn) {
      s0 = *(const uint4*)(S + lane * DM_PS);
      s1 = *(const uint4*)(S + lane * DM_PS + 4);
    }
    const unsigned sv[DM_SR] = {s0.x, s0.y, s0.z, s0.w,
                                s1.x, s1.y, s1.z, s1.w};
#pragma unroll
    for (int i = 0; i < DM_SR; ++i) {
      // only the row's nonzero words: a uniform loop, no predicated work
      for (unsigned m = __ballot_sync(0xffffffffu, sv[i] != 0u); m;
           m &= m - 1u) {
        const int w = __ffs(m) - 1;
        const unsigned x = __shfl_sync(0xffffffffu, sv[i], w);
        const uint4 t0 = *(const uint4*)(T + w * DM_PA);
        const uint4 t1 = *(const uint4*)(T + w * DM_PA + 128);
        acc[i][0] |= x & t0.x;
        acc[i][1] |= x & t0.y;
        acc[i][2] |= x & t0.z;
        acc[i][3] |= x & t0.w;
        acc[i][4] |= x & t1.x;
        acc[i][5] |= x & t1.y;
        acc[i][6] |= x & t1.z;
        acc[i][7] |= x & t1.w;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  // lane l's actives are columns 4l..4l+3 and 128+4l..128+4l+3
  unsigned char* s_out = (unsigned char*)sm.stage;
#pragma unroll
  for (int i = 0; i < DM_SR; ++i) {
    const int r = warp * DM_SR + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 128 * h + 4 * lane + j;
        if (acc[i][4 * h + j] != 0u && dm_dep(sm.lanes, wt, nk1, r, c))
          word |= 1u << (8 * j);
      }
      *(unsigned*)(s_out + r * DM_OP + 128 * h + 4 * lane) = word;
    }
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
