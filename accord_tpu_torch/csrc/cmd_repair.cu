// K12: the command plane's shadow repair scatter.
//
// Replaces accord_tpu/ops/kernels.py `_cmd_repair_body` (:1347), the
// scatter that the reference runs inside protocol_tick: the host shadows'
// current values of the dirty rows and kids written over the device
// columns (status, flags, durability i32[cap]; promised, accepted,
// execute_at i32[cap, 3]; kmax i32[kcap, 3]; kvalid bool[kcap]). It is
// idempotent: a repair writes exactly what a flush would. Functional like
// K3/K4/K8: the outputs are fresh columns. Indices follow jnp's
// `.at[].set(mode="drop")` (norm_index): the padding sentinels cap / kcap
// drop; the plane's dirty rows and kids are distinct.
//
// Design: one launch copies the eight columns (common.cuh's multi_copy),
// then ONE launch scatters all eight lanes, one thread per (index, lane
// element): 12 elements per dirty row (status, flags, promised[3],
// accepted[3], execute_at[3], durability), 4 per dirty kid (kmax[3],
// kvalid).
//
// What bounds it: bytes, the whole-column copy (33 bytes a row and 13 a
// kid, read and written); the m + k dirty entries are noise beside it. An
// in-place update is a later change (the reference's program updates the
// columns in place inside the fused tick).
#include "common.cuh"

struct RepairCols {
  int* st;
  int* fl;
  int* pr;
  int* ab;
  int* ea;
  int* du;
  int* km;
  unsigned char* kv;
};

struct RepairVals {
  const int* rows;
  const int* st;
  const int* fl;
  const int* pr;
  const int* ab;
  const int* ea;
  const int* du;
  const int* kids;
  const int* km;
  const unsigned char* kv;
};

__global__ void cmd_repair_kernel(RepairCols c, int cap, int kcap,
                                  RepairVals v, int m, int k) {
  const long long nr = 12LL * m;
  const long long n = nr + 4LL * k;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < n;
       t += stride) {
    if (t < nr) {
      const int i = (int)(t / 12);
      const int e = (int)(t - 12LL * i);
      const int r = norm_index(v.rows[i], cap);
      if (r < 0) continue;
      if (e == 0) {
        c.st[r] = v.st[i];
      } else if (e == 1) {
        c.fl[r] = v.fl[i];
      } else if (e < 5) {
        c.pr[r * 3 + e - 2] = v.pr[i * 3 + e - 2];
      } else if (e < 8) {
        c.ab[r * 3 + e - 5] = v.ab[i * 3 + e - 5];
      } else if (e < 11) {
        c.ea[r * 3 + e - 8] = v.ea[i * 3 + e - 8];
      } else {
        c.du[r] = v.du[i];
      }
    } else {
      const long long u = t - nr;
      const int i = (int)(u >> 2);
      const int e = (int)(u & 3);
      const int q = norm_index(v.kids[i], kcap);
      if (q < 0) continue;
      if (e < 3)
        c.km[q * 3 + e] = v.km[i * 3 + e];
      else
        c.kv[q] = v.kv[i];
    }
  }
}

// the eight input columns, the eight fresh outputs, then the index and
// value lanes: rows_idx[m], st/fl/du [m], pr/ab/ea [m, 3], kid_idx[k],
// km [k, 3], kv [k]
extern "C" int cmd_repair(
    const void* st, const void* fl, const void* pr, const void* ab,
    const void* ea, const void* du, const void* km, const void* kv,
    void* o_st, void* o_fl, void* o_pr, void* o_ab, void* o_ea, void* o_du,
    void* o_km, void* o_kv, int cap, int kcap, const void* rows_idx,
    const void* st_v, const void* fl_v, const void* pr_v, const void* ab_v,
    const void* ea_v, const void* du_v, const void* kid_idx,
    const void* km_v, const void* kv_v, int m, int k, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[8] = {st, fl, pr, ab, ea, du, km, kv};
  void* out[8] = {o_st, o_fl, o_pr, o_ab, o_ea, o_du, o_km, o_kv};
  const long long bytes[8] = {4LL * cap, 4LL * cap,  12LL * cap, 12LL * cap,
                              12LL * cap, 4LL * cap, 12LL * kcap, 1LL * kcap};
  CopyTable t;
  for (int i = 0; i < 8; ++i) {
    t.src[i] = (const unsigned char*)in[i];
    t.dst[i] = (unsigned char*)out[i];
    t.bytes[i] = bytes[i];
  }
  t.n = 8;
  int rc = launch_multi_copy(t, s);
  if (rc != 0) return rc;
  const long long n = 12LL * m + 4LL * k;
  if (n == 0) return 0;
  RepairCols c{(int*)o_st, (int*)o_fl, (int*)o_pr, (int*)o_ab,
               (int*)o_ea, (int*)o_du, (int*)o_km, (unsigned char*)o_kv};
  RepairVals v{(const int*)rows_idx, (const int*)st_v, (const int*)fl_v,
               (const int*)pr_v,     (const int*)ab_v, (const int*)ea_v,
               (const int*)du_v,     (const int*)kid_idx,
               (const int*)km_v,     (const unsigned char*)kv_v};
  cmd_repair_kernel<<<grid_for(n, 256), 256, 0, s>>>(c, cap, kcap, v, m, k);
  ACCORD_CHECK();
  return 0;
}
