// K4: the lane table -- row and word scatters with drop-on-out-of-range
// indices, and the fill-and-copy of arena growth, each ONE launch a call.
//
// Replaces accord_tpu/ops/kernels.py `scatter_rows` (:242, the dirty-row
// lane delta behind ops/deltas.flush_lane and flush_lanes),
// `kid_word_scatter` (:250, the per-key packed row-mask table),
// `arena_grow` (:864) and `range_scatter` (:852, the range arena's five
// lanes -- start, end, ts[3], kind, valid).
//
// Functional, like the JAX kernels: each call writes freshly allocated
// outputs. One launch takes a table of up to LT_MAX lanes by value; lane k
// is dst = src (its first n_src rows; rows past them get `fill`) with
// dst[idx[i]] = rows[i] for its own index list (the 2-D word form sets
// word widx[i] of row idx[i] to the 32-bit rows[i]). What bounds it: bytes,
// each lane read once and written once (a [cap, 3] i32 lane is 192 KB at
// cap 16384, the kid table KC * cap/32 words 2 MB at KC 1024) -- and, for
// a burn's small lanes, the launch itself. The design, owner-block
// copy-then-patch: the grid splits each lane's output rows into
// contiguous ranges of about LT_BLOCK_BYTES, one range per block. A block
// copies (or fills) its range in 16-byte pieces where the lane's alignment
// allows (else 4-byte, else bytes), waits at __syncthreads(), then walks
// the lane's index list -- staged in shared memory LT_CHUNK at a time,
// normalised with norm_index -- and writes the dirty rows that fall in its
// range, each row spread over threads in 16-, 4- or 1-byte pieces. One
// block owns every output row, so the copy and the patch cannot race;
// duplicate indices carry identical data, so the result is the plain
// version's bit for bit.
//
// K15 (lane_slice_many, the merged tick's per-plan windows) is at the end.
#include <string.h>

#include "common.cuh"

#define LT_MAX 8              // lanes per launch
#define LT_THREADS 256
#define LT_BLOCK_BYTES 8192   // output bytes a block owns (at least a row)
#define LT_CHUNK 256          // index entries staged per pass
#define LT_FIELDS 10          // int64 fields of one lane in the host table

struct Lane {
  unsigned char* dst;
  const unsigned char* src;
  const unsigned char* rows;  // m rows (1-D) or m 32-bit words (2-D)
  const int* idx;             // m row indices, or null: copy/fill only
  const int* widx;            // m word indices (2-D word form), or null
  long long n_rows;           // output rows
  long long n_src;            // rows copied from src; the rest are filled
  int row_bytes;
  int m;
  int rows_per_block;
  int block0;                 // this lane's first block
  unsigned fill;              // byte (offset & 3) of the pattern fills a byte
};

struct LaneTable {
  Lane l[LT_MAX];
  int n;
};

// the widest piece (16, 4 or 1 bytes) that both addresses' alignment allow
__device__ __forceinline__ int piece_for(uintptr_t a, uintptr_t b) {
  const uintptr_t u = a | b;
  return (u & 15) == 0 ? 16 : (u & 3) == 0 ? 4 : 1;
}

// d[0:n] = s[0:n] by the block: bytes up to d's 16- (or 4-) byte boundary,
// then whole pieces, then the tail bytes
__device__ void block_copy(unsigned char* d, const unsigned char* s,
                           long long n) {
  const uintptr_t mis = (uintptr_t)d ^ (uintptr_t)s;
  const int vec = (mis & 15) == 0 ? 16 : (mis & 3) == 0 ? 4 : 1;
  long long head = (vec - ((uintptr_t)d & (vec - 1))) & (vec - 1);
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head; i += blockDim.x) d[i] = s[i];
  long long done = head;
  if (vec == 16) {
    const long long nv = (n - head) >> 4;
    uint4* dv = (uint4*)(d + head);
    const uint4* sv = (const uint4*)(s + head);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) dv[i] = sv[i];
    done += nv << 4;
  } else if (vec == 4) {
    const long long nv = (n - head) >> 2;
    unsigned* dv = (unsigned*)(d + head);
    const unsigned* sv = (const unsigned*)(s + head);
    for (long long i = threadIdx.x; i < nv; i += blockDim.x) dv[i] = sv[i];
    done += nv << 2;
  }
  for (long long i = done + threadIdx.x; i < n; i += blockDim.x) d[i] = s[i];
}

__device__ __forceinline__ unsigned char fill_byte(unsigned pat,
                                                   long long off) {
  return (unsigned char)(pat >> (8 * (off & 3)));
}

// lane bytes [a, b) = the fill pattern (byte o of the lane is byte o & 3 of
// `pat`)
__device__ void block_fill(unsigned char* base, long long a, long long b,
                           unsigned pat) {
  unsigned char* d = base + a;
  const long long n = b - a;
  if (n <= 0) return;
  long long head = (16 - ((uintptr_t)d & 15)) & 15;
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head; i += blockDim.x)
    d[i] = fill_byte(pat, a + i);
  const long long nv = (n - head) >> 4;
  const int p = (int)((a + head) & 3);   // phase of every 16-byte piece
  const unsigned w = p == 0 ? pat : (pat >> (8 * p)) | (pat << (32 - 8 * p));
  uint4* dv = (uint4*)(d + head);
  for (long long i = threadIdx.x; i < nv; i += blockDim.x)
    dv[i] = make_uint4(w, w, w, w);
  for (long long i = head + (nv << 4) + threadIdx.x; i < n; i += blockDim.x)
    d[i] = fill_byte(pat, a + i);
}

__global__ void __launch_bounds__(LT_THREADS)
    lane_table_kernel(const __grid_constant__ LaneTable t) {
  __shared__ int s_row[LT_CHUNK];
  __shared__ int s_ent[LT_CHUNK];
  __shared__ int s_cnt;
  int k = 0;
  while (k + 1 < t.n && (int)blockIdx.x >= t.l[k + 1].block0) ++k;
  const Lane& L = t.l[k];
  const long long rb = L.row_bytes;
  const long long r0 = (long long)(blockIdx.x - L.block0) * L.rows_per_block;
  const long long r1 = min(r0 + L.rows_per_block, L.n_rows);
  // 1. copy this block's rows from src, fill those past n_src
  const long long c1 = min(r1, L.n_src);
  if (r0 < c1) block_copy(L.dst + r0 * rb, L.src + r0 * rb, (c1 - r0) * rb);
  block_fill(L.dst, max(r0, L.n_src) * rb, r1 * rb, L.fill);
  if (L.idx == nullptr || L.m <= 0) return;   // uniform across the block
  __syncthreads();
  // 2. patch the dirty rows (or words) this block owns
  const bool words = L.widx != nullptr;
  const int n_words = L.row_bytes >> 2;
  // a row's piece: what both bases' alignment and the row's size allow
  const int piece = min(piece_for((uintptr_t)L.dst, (uintptr_t)L.rows),
                        (L.row_bytes & 15) == 0 ? 16
                        : (L.row_bytes & 3) == 0 ? 4 : 1);
  const int pieces = L.row_bytes / piece;
  for (int c0 = 0; c0 < L.m; c0 += LT_CHUNK) {
    if (threadIdx.x == 0) s_cnt = 0;
    __syncthreads();
    const int n = min(LT_CHUNK, L.m - c0);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int r = norm_index(L.idx[c0 + j], (int)L.n_rows);
      if (r < r0 || r >= r1) continue;           // dropped, or not ours
      if (words) {
        // a 2-D entry is one word: its thread writes it
        const int col = norm_index(L.widx[c0 + j], n_words);
        if (col >= 0)
          ((unsigned*)(L.dst + (long long)r * rb))[col] =
              ((const unsigned*)L.rows)[c0 + j];
        continue;
      }
      const int slot = atomicAdd(&s_cnt, 1);
      s_row[slot] = r;
      s_ent[slot] = c0 + j;
    }
    __syncthreads();
    if (!words) {
      const int cnt = s_cnt;
      const int items = cnt * pieces;
      for (int it = threadIdx.x; it < items; it += blockDim.x) {
        const int e = it / pieces;
        const int p = it - e * pieces;
        const long long dof = (long long)s_row[e] * rb + (long long)p * piece;
        const long long sof = (long long)s_ent[e] * rb + (long long)p * piece;
        if (piece == 16)
          *(uint4*)(L.dst + dof) = *(const uint4*)(L.rows + sof);
        else if (piece == 4)
          *(unsigned*)(L.dst + dof) = *(const unsigned*)(L.rows + sof);
        else
          L.dst[dof] = L.rows[sof];
      }
    }
    __syncthreads();
  }
}

// One launch over `n` lanes described by the host table `spec` (LT_FIELDS
// int64 a lane, in any alignment: dst, src, rows, idx, widx, n_rows,
// n_src, row_bytes, m, fill). Launches nothing when every lane is empty.
extern "C" int lane_table(const void* spec, int n, void* stream) {
  if (n < 1 || n > LT_MAX) return (int)cudaErrorInvalidValue;
  LaneTable t;
  t.n = n;
  long long blocks = 0;
  for (int k = 0; k < n; ++k) {
    long long f[LT_FIELDS];
    memcpy(f, (const char*)spec + sizeof(f) * k, sizeof(f));
    Lane& L = t.l[k];
    L.dst = (unsigned char*)f[0];
    L.src = (const unsigned char*)f[1];
    L.rows = (const unsigned char*)f[2];
    L.idx = (const int*)f[3];
    L.widx = (const int*)f[4];
    L.n_rows = f[5];
    L.n_src = f[6];
    L.row_bytes = (int)f[7];
    L.m = (int)f[8];
    L.fill = (unsigned)f[9];
    if (L.n_rows < 0 || L.n_src < 0 || L.n_src > L.n_rows ||
        L.row_bytes < 0 || L.m < 0 || L.n_rows >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    if (L.widx != nullptr && (L.row_bytes & 3) != 0)
      return (int)cudaErrorInvalidValue;
    L.rows_per_block = L.row_bytes >= LT_BLOCK_BYTES || L.row_bytes == 0
                           ? 1 : LT_BLOCK_BYTES / L.row_bytes;
    L.block0 = (int)blocks;
    if (L.row_bytes > 0)
      blocks += (L.n_rows + L.rows_per_block - 1) / L.rows_per_block;
  }
  if (blocks == 0) return 0;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  lane_table_kernel<<<(unsigned)blocks, LT_THREADS, 0,
                      (cudaStream_t)stream>>>(t);
  ACCORD_CHECK();
  return 0;
}

// K15: lane_slice_many, every plan's [rows x words] window of the merged
// packed results in ONE launch (accord_tpu/ops/node_lane.py `lane_slice`
// :190, a jax.lax.dynamic_slice, once a window). A window names its source
// (up to LS_SRCS packed results), its row and word offsets, its shape and
// its offset in the flat output. Like dynamic_slice, a negative start
// counts from the end, and each is clamped so the window stays inside its
// source. With `offs` set, window 0's offsets come from device memory
// (offs[0] = row, offs[1] = word), so a captured launch replays with new
// offsets (lane_slice's one-window form). The grid is (tiles, windows):
// consecutive threads copy consecutive pieces of a row, 16 bytes wide
// where the window's word offset, its width, the source's row stride and
// its output offset allow, else 4. What bounds it: bytes, each window read
// once and written once -- and, at a burn's sizes, the launch.
#define LS_SRCS 4
#define LS_THREADS 256
#define LS_SMALL 64           // windows of the small table
#define LS_LARGE 1024         // windows of the large table (more: chunks)

struct Window {
  int src, r0, w0, rows, words, out;
};

template <int N>
struct WindowTable {
  const unsigned* src[LS_SRCS];
  int nr[LS_SRCS];
  int nw[LS_SRCS];
  unsigned* out;
  const int* offs;
  Window w[N];
};

template <int N>
__global__ void __launch_bounds__(LS_THREADS)
    lane_slice_kernel(const __grid_constant__ WindowTable<N> t) {
  const Window& w = t.w[blockIdx.y];
  const int s = w.src;
  const int nr = t.nr[s], nw = t.nw[s];
  int r0 = w.r0, w0 = w.w0;
  if (t.offs != nullptr && blockIdx.y == 0) {
    r0 = t.offs[0];
    w0 = t.offs[1];
  }
  if (r0 < 0) r0 += nr;             // dynamic_slice: negative from the end
  if (w0 < 0) w0 += nw;
  r0 = min(max(r0, 0), nr - w.rows);
  w0 = min(max(w0, 0), nw - w.words);
  const unsigned* src = t.src[s] + (long long)r0 * nw + w0;
  unsigned* out = t.out + w.out;
  const bool vec = ((w0 | nw | w.words | w.out) & 3) == 0 &&
                   (((uintptr_t)t.src[s] | (uintptr_t)t.out) & 15) == 0;
  const unsigned per_row = vec ? (unsigned)(w.words >> 2) : (unsigned)w.words;
  const unsigned items = per_row * (unsigned)w.rows;
  for (unsigned i = blockIdx.x * LS_THREADS + threadIdx.x; i < items;
       i += gridDim.x * LS_THREADS) {
    const unsigned r = i / per_row;
    const unsigned c = i - r * per_row;
    if (vec)
      ((uint4*)(out + (long long)r * w.words))[c] =
          ((const uint4*)(src + (long long)r * nw))[c];
    else
      out[(long long)r * w.words + c] = src[(long long)r * nw + c];
  }
}

template <int N>
static int launch_windows(const long long* srcs, int n_src,
                          const char* wins, int n, const void* offs,
                          void* out, cudaStream_t st) {
  WindowTable<N> t;
  for (int s = 0; s < LS_SRCS; ++s) {
    t.src[s] = s < n_src ? (const unsigned*)srcs[3 * s] : nullptr;
    t.nr[s] = s < n_src ? (int)srcs[3 * s + 1] : 0;
    t.nw[s] = s < n_src ? (int)srcs[3 * s + 2] : 0;
  }
  t.out = (unsigned*)out;
  t.offs = (const int*)offs;
  long long most = 1;
  for (int k = 0; k < n; ++k) {
    long long f[6];
    memcpy(f, wins + sizeof(f) * k, sizeof(f));
    Window& w = t.w[k];
    w.src = (int)f[0];
    w.r0 = (int)f[1];
    w.w0 = (int)f[2];
    w.rows = (int)f[3];
    w.words = (int)f[4];
    w.out = (int)f[5];
    if (w.src < 0 || w.src >= n_src || t.src[w.src] == nullptr ||
        w.rows < 0 || w.words < 0 || w.rows > t.nr[w.src] ||
        w.words > t.nw[w.src] || f[5] < 0 ||
        f[5] + (long long)w.rows * w.words >= (1LL << 31))
      return (int)cudaErrorInvalidValue;
    const long long items = (long long)w.rows * w.words;
    if (items > most) most = items;
  }
  long long tiles = (most + LS_THREADS - 1) / LS_THREADS;
  if (tiles > 1024) tiles = 1024;
  lane_slice_kernel<N><<<dim3((unsigned)tiles, (unsigned)n), LS_THREADS, 0,
                         st>>>(t);
  ACCORD_CHECK();
  return 0;
}

// `spec`: n_src x (pointer, rows, words), then n x (src, r0, w0, rows,
// words, out offset in words), int64 each, in any alignment. One launch for
// up to LS_LARGE windows (the small table's for up to LS_SMALL); more
// windows launch once per LS_LARGE. `offs` (window 0's device offsets)
// needs n == 1.
extern "C" int lane_slice_many(const void* spec, int n_src, int n,
                               const void* offs, void* out, void* stream) {
  if (n_src < 1 || n_src > LS_SRCS || n < 0 || (offs != nullptr && n != 1))
    return (int)cudaErrorInvalidValue;
  long long srcs[3 * LS_SRCS];
  memcpy(srcs, spec, sizeof(long long) * 3 * n_src);
  const char* wins = (const char*)spec + sizeof(long long) * 3 * n_src;
  cudaStream_t st = (cudaStream_t)stream;
  if (n <= LS_SMALL)
    return n == 0 ? 0
                  : launch_windows<LS_SMALL>(srcs, n_src, wins, n, offs, out,
                                             st);
  for (int k = 0; k < n; k += LS_LARGE) {
    const int rc = launch_windows<LS_LARGE>(srcs, n_src,
                                            wins + 6 * sizeof(long long) * k,
                                            min(LS_LARGE, n - k), nullptr,
                                            out, st);
    if (rc != 0) return rc;
  }
  return 0;
}
