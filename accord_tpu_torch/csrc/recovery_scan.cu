// K11: the command plane's recovery-candidate scan.
//
// Replaces accord_tpu/ops/kernels.py `recovery_scan` (:682, body
// `_recovery_scan_body` :667). Row r of the command arena is a candidate
// iff PRE_ACCEPTED (1) <= status[r] < APPLIED (9) -- the live band, which
// leaves out the INVALIDATED / TRUNCATED terminals above it -- and
// (now_ms - touched_ms[r]) >= stall_ms, the subtraction in wrapping int32
// (done in unsigned here: signed overflow is undefined in C++, XLA wraps).
// The output is the frontier_compact contract: indptr i32[2] (exact past
// out_cap), the candidate rows ascending in rows i32[out_cap] (0 beyond
// the count), and the checksum with seeds 13 / 17 over indptr and all
// out_cap rows.
//
// Design: two launches, no memset. One warp per 32-row word packs the
// predicate with __ballot_sync into cap/32 words of scratch (one segment);
// then common.cuh's launch_csr compacts that segment in one launch, the
// compaction K2 / K6 / K9 run.
//
// What bounds it: bytes, status and touched read once (8 bytes a row: 131
// KB at cap 16384) plus the outputs; the two launches' latency dominates
// at every cap the plane reaches.
#include "common.cuh"

#define RS_LIVE_LO 1   // CMD_ST_PRE_ACCEPTED
#define RS_LIVE_HI 9   // CMD_ST_APPLIED

__global__ void stall_pack_kernel(const int* __restrict__ status,
                                  const int* __restrict__ touched, int cap,
                                  int now_ms, int stall_ms,
                                  unsigned* __restrict__ packed, int words) {
  const int lane = threadIdx.x & 31;
  const long long warps = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       w < words; w += warps) {  // uniform across the warp
    const long long r = (w << 5) + lane;
    bool p = false;
    if (r < cap) {
      const int st = status[r];
      const int age = (int)((unsigned)now_ms - (unsigned)touched[r]);
      p = st >= RS_LIVE_LO && st < RS_LIVE_HI && age >= stall_ms;
    }
    const unsigned bits = __ballot_sync(0xffffffffu, p);
    if (lane == 0) packed[w] = bits;
  }
}

struct PackedSrc {
  const unsigned* packed;
  int w;
  __device__ __forceinline__ unsigned word(int, int, long long f,
                                           unsigned* kw) const {
    *kw = 0u;
    return packed[f];
  }
};

// status/touched i32[cap] (cap % 32 == 0); packed: cap/32 words of
// scratch; indptr[2], rows[out_cap], csum; scratch:
// kernels.csr_scratch_bytes(1, tiles of cap/32 words) zeroed bytes, left
// zeroed
extern "C" int recovery_scan(const void* status, const void* touched, int cap,
                             int now_ms, int stall_ms, int out_cap,
                             void* packed, void* indptr, void* rows,
                             void* csum, void* scratch, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cap <= 0 || cap % 32) return (int)cudaErrorInvalidValue;
  const int words = cap / 32;
  stall_pack_kernel<<<grid_for(32LL * words, 256), 256, 0, st>>>(
      (const int*)status, (const int*)touched, cap, now_ms, stall_ms,
      (unsigned*)packed, words);
  ACCORD_CHECK();
  PackedSrc src{(const unsigned*)packed, words};
  return launch_csr(src, 1, nullptr, out_cap, (int*)indptr, (int*)rows,
                    nullptr, nullptr, (unsigned*)csum, scratch, st,
                    FoldSeeds{13u, 17u, 0u});
}
