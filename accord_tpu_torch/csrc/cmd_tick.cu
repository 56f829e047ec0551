// K10: the command plane's batched protocol transitions.
//
// Replaces accord_tpu/ops/kernels.py `cmd_tick` (:1032, body
// `_cmd_tick_body` :1101): a batch of n ops (PreAccept, Accept, Commit,
// Apply) evaluated IN ORDER over the command arena's columns -- status,
// flags, durability i32[cap]; promised, accepted, execute_at i32[cap, 3];
// kmax i32[kcap, 3]; kvalid bool[kcap] -- and the node's clock register.
// Op i sees its row as its previous in-batch writer left it (op_prev[i],
// -1 = the pre-batch column value) and each kid slot s as its previous
// writer (op_kprev[i, s] = p * kpad + s', -1 = the pre-batch value). The
// PreAccept lane is commands.preaccept (the fast-path test against the
// kids' max conflict, unique_now, expiry), the Accept lane the ballot
// checks, Commit and Apply the status promotions (with `promote`, the
// empty-deps maybe_execute promotion too). After the walk each row's and
// kid's LAST writer (op_rlast / op_klast) scatters its chain values into
// fresh copies of the columns (index out of range dropped, negative
// wrapped: jnp's `.at[].set(mode="drop")`), and the result block is
// folded into the checksum (seeds 3 / 7 / 11 / 13 over out_code,
// out_status, out_ts and the clock).
//
// Bit for bit with the reference:
//   * padding slots are computed, not skipped: op_kind 0, op_flags 0, row
//     0, kids -1; they gather row 0 / kid 0, report status[0] and an out_ts
//     from the witness arithmetic, only out_code is -1, and the checksum
//     folds all n slots;
//   * three-lane lexicographic compares are signed (Ballot.ZERO's lane2 is
//     -2^31, an undecided executeAt is INT32_MIN in every lane, the masked
//     kid max is INT32_MIN lanes when no kid is valid);
//   * unique_now's clock + 1 and al_hlc + 1 wrap in int32 (computed in
//     unsigned here: signed overflow is undefined in C++, XLA wraps);
//   * a kid slot's validity reads kv_raw & (kid >= 0), but the chain keeps
//     kv_raw | do_reg unmasked, as the reference's carry does;
//   * an index into the op-sized chains (op_prev, op_kprev / kpad) past n
//     clamps to n - 1, as jnp's dynamic index does.
// Beyond the reference, the op-sized chains are an output too (chains
// i32[n, 12 + 4 kpad]: status, flags, promised[3], accepted[3],
// execute_at[3], durability, then (kmax[3], kvalid) per slot), so the
// host takes a touched row's new values from its last writer's chain
// instead of reading whole columns back.
//
// Design, one block: (0) a grid-wide launch copies the eight columns into
// the fresh outputs (common.cuh's multi_copy); (a) the block's threads
// gather every op's pre-batch row and kid views into the chain buffer,
// and stage the op lanes beside it; (b) ONE thread walks the ops in order,
// reading only the op-sized chains and lanes (the reference's fori_loop
// carries exactly that), writing each op's post-values over its own view
// and its out_code / out_ts / out_status; (c) the threads scatter the last
// writers into the fresh columns, copy the chains out and fold the
// checksum. The chains and the staged lanes (12 + 4 kpad + 13 + 2 kpad
// ints an op: 196 bytes at kpad 4, 100 KB at tier 512) sit in dynamic
// shared memory up to tier 1024; above that the chains live in the chain
// output itself (global memory, L2-resident) and the walk reads the op
// lanes where they are.
//
// What bounds it: the walk is serial by nature -- each op may read the
// previous op's chain, and the clock carries through every PreAccept -- so
// its time is n times one op's dependent latency, far above the bytes
// bound (the column copy plus the op lanes); the copy is the only
// bandwidth-bound part.
#include "common.cuh"

#define KMAX 8         // kid slots per op at most
#define RL 12          // row lanes in a chain
#define WT 256         // threads of the walking block
// the chains and staged op lanes go to dynamic shared memory up to this
// many bytes (tier 1024 at kpad 4), to global memory above; kpad 4 runs a
// specialised walk. Both can be overridden at build time
// (-DCMD_TICK_SMEM_MAX=0, -DCMD_TICK_KPAD4=0) to time either side of each
// fork: tools/cmd_tick_variants.py
#ifndef CMD_TICK_SMEM_MAX
#define CMD_TICK_SMEM_MAX (200 * 1024)
#endif
#ifndef CMD_TICK_KPAD4
#define CMD_TICK_KPAD4 1
#endif

#define ST_PRE_ACCEPTED 1
#define ST_ACCEPTED 3
#define ST_COMMITTED 5
#define ST_STABLE 6
#define ST_READY 7
#define ST_PRE_APPLIED 8
#define ST_APPLIED 9
#define ST_INVALIDATED 10
#define ST_TRUNCATED 11

#define OUT_SUCCESS 0
#define OUT_REDUNDANT 1
#define OUT_REJECTED_BALLOT 2
#define OUT_TRUNCATED 3
#define OUT_INSUFFICIENT 4
#define OUT_INCONSISTENT_BIT 8
#define OUT_WAS_STABLE_BIT 16

#define F_PERMIT_FAST 1
#define F_EPOCH_OK 2
#define F_EXPIRED 4
#define F_MSG_HAS_TXN 8
#define F_VALID 16
#define F_DEPS_EMPTY 32

#define NEG ((int)0x80000000)

struct TickCols {
  const int* st;
  const int* fl;
  const int* pr;
  const int* ab;
  const int* ea;
  const int* du;
  const int* km;
  const unsigned char* kv;
};

struct TickOuts {
  int* st;
  int* fl;
  int* pr;
  int* ab;
  int* ea;
  int* du;
  int* km;
  unsigned char* kv;
};

struct TickOps {
  const int* kind;
  const int* row;
  const int* txn;
  const int* bal;
  const int* exec;
  const int* keys;
  const int* flags;
  const int* now;
  const int* prev;
  const unsigned char* rlast;
  const int* kprev;
  const unsigned char* klast;
};

struct TickScalars {
  int clock, node_epoch, lane2_clean, lane2_rej, dur_local, promote;
};

struct TickResult {
  int* code;
  int* status;
  int* ts;
  int* chains;
  int* clock;
  unsigned* csum;
};

__device__ __forceinline__ int wrap_inc(int x) {
  return (int)((unsigned)x + 1u);
}

// local/Node.unique_now's twin: hlc = max(now, clock + 1), bumped past
// at_least.hlc; epoch = max(node epoch, at_least.epoch). Returns the hlc.
__device__ __forceinline__ int unique_now(int now, int clock, int node_epoch,
                                          int al_ep, int al_hlc, int lane2,
                                          int* w) {
  int h = max(now, wrap_inc(clock));
  if (al_hlc >= h) h = wrap_inc(al_hlc);
  w[0] = max(node_epoch, al_ep);
  w[1] = h;
  w[2] = lane2;
  return h;
}

__device__ __forceinline__ void copy3(int* d, const int* s) {
  d[0] = s[0];
  d[1] = s[1];
  d[2] = s[2];
}

__device__ __forceinline__ bool lt3(const int* a, const int* b) {
  return lex_before(a[0], a[1], a[2], b[0], b[1], b[2]);
}

__device__ __forceinline__ bool eq3(const int* a, const int* b) {
  return a[0] == b[0] && a[1] == b[1] && a[2] == b[2];
}

// the walk: ONE thread, ops in order. ch: the chains (op i's view, then its
// post-values), c ints an op; the op lanes in SoA (kind, flags, now, prev:
// n each; txn, bal, exec: 3n; keys, kprev: kpad * n).
template <int KPC>
__device__ void walk(int* ch, int c, int n, int kpad_rt, const int* o_kind,
                     const int* o_flags, const int* o_now, const int* o_prev,
                     const int* o_txn, const int* o_bal, const int* o_exec,
                     const int* o_keys, const int* o_kprev,
                     const TickScalars& sc, const TickResult& res) {
  const int kpad = KPC > 0 ? KPC : kpad_rt;
  int clk = sc.clock;
  for (int i = 0; i < n; ++i) {
    const int f = o_flags[i];
    const int kind = o_kind[i];
    const bool valid = (f & F_VALID) != 0;
    const int prev = o_prev[i];
    const int* src = ch + (long long)(prev >= 0 ? min(prev, n - 1) : i) * c;
    const int st = src[0], fl = src[1], du = src[11];
    int pr[3], ab[3], ea[3], txn[3], bal[3], oex[3];
    copy3(pr, src + 2);
    copy3(ab, src + 5);
    copy3(ea, src + 8);
    copy3(txn, o_txn + 3 * i);
    copy3(bal, o_bal + 3 * i);
    copy3(oex, o_exec + 3 * i);
    const bool permit_fast = (f & F_PERMIT_FAST) != 0;
    const bool epoch_ok = (f & F_EPOCH_OK) != 0;
    const bool expired = (f & F_EXPIRED) != 0;
    const bool msg_has_txn = (f & F_MSG_HAS_TXN) != 0;
    const bool deps_empty = (f & F_DEPS_EMPTY) != 0;
    const int now = o_now[i];

    const bool has_txn = (fl & 1) != 0;
    const bool ea_set = ea[0] != NEG;
    const bool terminal = st == ST_INVALIDATED || st == ST_TRUNCATED;
    const bool pr_gt_bal = lt3(bal, pr);
    const int* pr_max_bal = lt3(pr, bal) ? bal : pr;
    const int term_code =
        st == ST_INVALIDATED ? OUT_REJECTED_BALLOT : OUT_TRUNCATED;

    // kid chain: each slot reads its previous in-batch writer's post-value
    int km[KMAX][3], kids[KMAX];
    bool kvr[KMAX], kvm[KMAX];
    int mc[3] = {NEG, NEG, NEG};
    bool mc_any = false;
#pragma unroll
    for (int s = 0; s < (KPC > 0 ? KPC : KMAX); ++s) {
      if (s >= kpad) break;
      const int link = o_kprev[i * kpad + s];
      kids[s] = o_keys[i * kpad + s];
      const int* ks =
          link >= 0 ? ch + (long long)min(link / kpad, n - 1) * c + RL +
                          4 * (link % kpad)
                    : ch + (long long)i * c + RL + 4 * s;
      copy3(km[s], ks);
      kvr[s] = ks[3] != 0;
      kvm[s] = kvr[s] && kids[s] >= 0;
      if (kvm[s] && (!mc_any || lt3(mc, km[s]))) {
        copy3(mc, km[s]);
        mc_any = true;
      }
    }

    // PreAccept (commands.preaccept)
    int rej_w[3], slow_w[3];
    const int rej_h =
        unique_now(now, clk, sc.node_epoch, txn[0], txn[1], sc.lane2_rej,
                   rej_w);
    const int* al = mc_any ? mc : txn;
    const int slow_h = unique_now(now, clk, sc.node_epoch, al[0], al[1],
                                  sc.lane2_clean, slow_w);
    const bool fast = permit_fast && (!mc_any || !lt3(txn, mc)) && epoch_ok;
    const int* witness = expired ? rej_w : (fast ? txn : slow_w);
    const int wit_clock = expired ? rej_h : (fast ? clk : slow_h);
    const bool pa_blocked = terminal || pr_gt_bal;
    const int pa_code = terminal ? term_code
                        : pr_gt_bal ? OUT_REJECTED_BALLOT
                        : (has_txn && permit_fast) ? OUT_REDUNDANT
                                                   : OUT_SUCCESS;
    const bool pa_wit = !pa_blocked && !has_txn && !ea_set;
    const int pa_st = (pa_blocked || has_txn) ? st
                      : ea_set ? max(st, ST_PRE_ACCEPTED)
                               : ST_PRE_ACCEPTED;
    const int pa_fl = pa_blocked ? fl : (fl | 1);
    const int* pa_pr = pa_blocked ? pr : pr_max_bal;
    const int* pa_ea = pa_wit ? witness : ea;

    // Accept (commands.accept)
    const bool committed = st >= ST_COMMITTED;
    const int ac_code =
        terminal ? term_code
        : (pr_gt_bal || committed)
            ? (committed ? OUT_REDUNDANT : OUT_REJECTED_BALLOT)
            : OUT_SUCCESS;
    const bool ac_ok = !terminal && !pr_gt_bal && !committed;
    const int ac_st = ac_ok ? ST_ACCEPTED : st;
    const int* ac_pr = ac_ok ? bal : pr;
    const int* ac_ab = ac_ok ? bal : ab;
    const int* ac_ea = ac_ok ? oex : ea;

    // Commit -> STABLE (commands.commit)
    const bool ea_eq = eq3(ea, oex);
    const bool stable = st >= ST_STABLE;
    const bool cm_incons = stable && !terminal && !ea_eq;
    const bool cm_insuf = !stable && !has_txn && !msg_has_txn;
    const bool cm_ok = !stable && !cm_insuf;
    const int cm_code = stable ? OUT_REDUNDANT +
                                     (cm_incons ? OUT_INCONSISTENT_BIT : 0)
                        : cm_insuf ? OUT_INSUFFICIENT
                                   : OUT_SUCCESS;
    const int cm_new_st =
        (sc.promote && deps_empty) ? ST_READY : ST_STABLE;
    const int cm_st = cm_ok ? cm_new_st : st;
    const int cm_fl = (cm_ok && msg_has_txn) ? (fl | 1) : fl;
    const int* cm_ea = cm_ok ? oex : ea;
    const int* cm_regval = lt3(oex, txn) ? txn : oex;

    // Apply -> PRE_APPLIED (commands.apply)
    const bool preapplied = st >= ST_PRE_APPLIED;
    const bool was_stable = st >= ST_STABLE;
    const bool ap_incons = preapplied && !terminal && !ea_eq;
    const bool ap_insuf = !preapplied && !has_txn && !msg_has_txn;
    const bool ap_ok = !preapplied && !ap_insuf;
    const int ap_code =
        preapplied ? OUT_REDUNDANT + (ap_incons ? OUT_INCONSISTENT_BIT : 0)
        : ap_insuf ? OUT_INSUFFICIENT
                   : OUT_SUCCESS + (was_stable ? OUT_WAS_STABLE_BIT : 0);
    const int ap_new_st =
        (sc.promote && deps_empty) ? ST_APPLIED : ST_PRE_APPLIED;
    const int ap_du =
        (sc.promote && ap_ok && deps_empty) ? max(du, sc.dur_local) : du;
    const int ap_st = ap_ok ? ap_new_st : st;
    const int ap_fl = (ap_ok && msg_has_txn) ? (fl | 1) : fl;
    const int* ap_ea = ap_ok ? oex : ea;

    // select per kind (any kind past COMMIT is an apply), gate on valid
    const int sel = kind == 0 ? 0 : kind == 1 ? 1 : kind == 2 ? 2 : 3;
    int n_st = st, n_fl = fl, n_du = du;
    const int *n_pr = pr, *n_ab = ab, *n_ea = ea;
    const int* ts_out;
    int code;
    bool ok;
    const int* regval;
    if (sel == 0) {
      if (valid) {
        n_st = pa_st;
        n_fl = pa_fl;
        n_pr = pa_pr;
        n_ea = pa_ea;
      }
      code = pa_code;
      ts_out = pa_ea;
      ok = pa_wit;
      regval = witness;
    } else if (sel == 1) {
      if (valid) {
        n_st = ac_st;
        n_pr = ac_pr;
        n_ab = ac_ab;
        n_ea = ac_ea;
      }
      code = ac_code;
      ts_out = ac_ea;
      ok = ac_ok;
      regval = oex;
    } else if (sel == 2) {
      if (valid) {
        n_st = cm_st;
        n_fl = cm_fl;
        n_ea = cm_ea;
      }
      code = cm_code;
      ts_out = cm_ea;
      ok = cm_ok;
      regval = cm_regval;
    } else {
      if (valid) {
        n_st = ap_st;
        n_fl = ap_fl;
        n_ea = ap_ea;
        n_du = ap_du;
      }
      code = ap_code;
      ts_out = ap_ea;
      ok = ap_ok;
      regval = cm_regval;
    }
    const bool do_reg = valid && ok;

    int out_ts[3], reg[3];
    copy3(out_ts, ts_out);
    copy3(reg, regval);
    int* dst = ch + (long long)i * c;
    int post[RL] = {n_st, n_fl, n_pr[0], n_pr[1], n_pr[2], n_ab[0],
                    n_ab[1], n_ab[2], n_ea[0], n_ea[1], n_ea[2], n_du};
#pragma unroll
    for (int e = 0; e < RL; ++e) dst[e] = post[e];
#pragma unroll
    for (int s = 0; s < (KPC > 0 ? KPC : KMAX); ++s) {
      if (s >= kpad) break;
      const bool better = !kvm[s] || lt3(km[s], reg);
      const bool take = do_reg && better && kids[s] >= 0;
      int* kd = dst + RL + 4 * s;
      copy3(kd, take ? reg : km[s]);
      kd[3] = (kvr[s] || do_reg) ? 1 : 0;
    }
    if (valid && sel == 0 && pa_wit) clk = wit_clock;
    res.code[i] = valid ? code : -1;
    copy3(res.ts + 3 * i, out_ts);
    res.status[i] = n_st;
  }
  *res.clock = clk;
}

template <int KPC>
__global__ void __launch_bounds__(WT)
cmd_tick_kernel(const TickCols in, const TickOuts out, int cap, int kcap,
                const TickOps ops, int n, int kpad_rt, const TickScalars sc,
                const TickResult res, int use_smem) {
  extern __shared__ int smem[];
  const int kpad = KPC > 0 ? KPC : kpad_rt;
  const int c = RL + 4 * kpad;
  int* ch = use_smem ? smem : res.chains;
  const int* o_kind = ops.kind;
  const int* o_flags = ops.flags;
  const int* o_now = ops.now;
  const int* o_prev = ops.prev;
  const int* o_txn = ops.txn;
  const int* o_bal = ops.bal;
  const int* o_exec = ops.exec;
  const int* o_keys = ops.keys;
  const int* o_kprev = ops.kprev;

  // (a) the pre-batch views, and (shared memory) the staged op lanes
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int r = ops.row[i];
    r = r < 0 ? 0 : (r >= cap ? cap - 1 : r);
    int* d = ch + (long long)i * c;
    d[0] = in.st[r];
    d[1] = in.fl[r];
    copy3(d + 2, in.pr + 3LL * r);
    copy3(d + 5, in.ab + 3LL * r);
    copy3(d + 8, in.ea + 3LL * r);
    d[11] = in.du[r];
    for (int s = 0; s < kpad; ++s) {
      int k = ops.keys[i * kpad + s];
      k = k < 0 ? 0 : (k >= kcap ? kcap - 1 : k);
      copy3(d + RL + 4 * s, in.km + 3LL * k);
      d[RL + 4 * s + 3] = in.kv[k] != 0 ? 1 : 0;
    }
  }
  if (use_smem) {
    int* lanes = smem + (long long)n * c;
    int* s_kind = lanes;
    int* s_flags = s_kind + n;
    int* s_now = s_flags + n;
    int* s_prev = s_now + n;
    int* s_txn = s_prev + n;
    int* s_bal = s_txn + 3 * n;
    int* s_exec = s_bal + 3 * n;
    int* s_keys = s_exec + 3 * n;
    int* s_kprev = s_keys + kpad * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_kind[i] = ops.kind[i];
      s_flags[i] = ops.flags[i];
      s_now[i] = ops.now[i];
      s_prev[i] = ops.prev[i];
    }
    for (int i = threadIdx.x; i < 3 * n; i += blockDim.x) {
      s_txn[i] = ops.txn[i];
      s_bal[i] = ops.bal[i];
      s_exec[i] = ops.exec[i];
    }
    for (int i = threadIdx.x; i < kpad * n; i += blockDim.x) {
      s_keys[i] = ops.keys[i];
      s_kprev[i] = ops.kprev[i];
    }
    o_kind = s_kind;
    o_flags = s_flags;
    o_now = s_now;
    o_prev = s_prev;
    o_txn = s_txn;
    o_bal = s_bal;
    o_exec = s_exec;
    o_keys = s_keys;
    o_kprev = s_kprev;
  }
  __syncthreads();

  // (b) the walk
  if (threadIdx.x == 0)
    walk<KPC>(ch, c, n, kpad, o_kind, o_flags, o_now, o_prev, o_txn, o_bal,
              o_exec, o_keys, o_kprev, sc, res);
  __syncthreads();

  // (c) last-writer scatter, chains out, checksum
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!ops.rlast[i]) continue;
    const int r = norm_index(ops.row[i], cap);
    if (r < 0) continue;
    const int* s = ch + (long long)i * c;
    out.st[r] = s[0];
    out.fl[r] = s[1];
    copy3(out.pr + 3LL * r, s + 2);
    copy3(out.ab + 3LL * r, s + 5);
    copy3(out.ea + 3LL * r, s + 8);
    out.du[r] = s[11];
  }
  for (int t = threadIdx.x; t < n * kpad; t += blockDim.x) {
    if (!ops.klast[t]) continue;
    const int i = t / kpad, s = t - i * kpad;
    const int k = norm_index(ops.keys[t], kcap);
    if (k < 0) continue;
    const int* v = ch + (long long)i * c + RL + 4 * s;
    copy3(out.km + 3LL * k, v);
    out.kv[k] = v[3] != 0 ? 1 : 0;
  }
  if (use_smem)
    for (long long t = threadIdx.x; t < (long long)n * c; t += blockDim.x)
      res.chains[t] = smem[t];
  unsigned s3 = 0u, s7 = 0u, s11 = 0u, s13 = 0u;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s3 += fold_term(res.code[i], (unsigned)i, 3u);
    s7 += fold_term(res.status[i], (unsigned)i, 7u);
  }
  for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
    s11 += fold_term(res.ts[i], (unsigned)i, 11u);
  if (threadIdx.x == 0) s13 = fold_term(*res.clock, 0u, 13u);
  s3 = block_sum_u32(s3);
  s7 = block_sum_u32(s7);
  s11 = block_sum_u32(s11);
  s13 = block_sum_u32(s13);
  if (threadIdx.x == 0) *res.csum = s3 ^ s7 ^ s11 ^ s13;
}

template <int KPC>
static int launch_tick(const TickCols& in, const TickOuts& out, int cap,
                       int kcap, const TickOps& ops, int n, int kpad,
                       const TickScalars& sc, const TickResult& res,
                       cudaStream_t st) {
  const size_t c = RL + 4 * (size_t)kpad;
  const size_t lanes = 13 + 2 * (size_t)kpad;
  const size_t smem = (size_t)n * (c + lanes) * sizeof(int);
  const int use_smem = smem <= CMD_TICK_SMEM_MAX ? 1 : 0;
  const size_t dyn = use_smem ? smem : 0;
  if (dyn > 48 * 1024) {
    cudaFuncSetAttribute(cmd_tick_kernel<KPC>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)dyn);
    ACCORD_CHECK();
  }
  cmd_tick_kernel<KPC><<<1, WT, dyn, st>>>(in, out, cap, kcap, ops, n, kpad,
                                           sc, res, use_smem);
  ACCORD_CHECK();
  return 0;
}

// the eight input columns, the eight fresh outputs, cap, kcap; the twelve
// op lanes (kind, row i32[n]; txn, ballot, exec i32[n, 3]; keys i32[n,
// kpad]; flags, now, prev i32[n]; rlast bool[n]; kprev i32[n, kpad];
// klast bool[n, kpad]), n, kpad (1..KMAX); the scalars; the result views
// (code[n], status[n], ts[n, 3], chains[n, 12 + 4 kpad], clock, csum)
extern "C" int cmd_tick(
    const void* st, const void* fl, const void* pr, const void* ab,
    const void* ea, const void* du, const void* km, const void* kv,
    void* o_st, void* o_fl, void* o_pr, void* o_ab, void* o_ea, void* o_du,
    void* o_km, void* o_kv, int cap, int kcap, const void* kind,
    const void* row, const void* txn, const void* bal, const void* exec,
    const void* keys, const void* flags, const void* now, const void* prev,
    const void* rlast, const void* kprev, const void* klast, int n, int kpad,
    int clock, int node_epoch, int lane2_clean, int lane2_rej, int dur_local,
    int promote, void* code, void* status, void* ts, void* chains,
    void* out_clock, void* csum, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || kpad < 1 || kpad > KMAX || cap <= 0 || kcap <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ins[8] = {st, fl, pr, ab, ea, du, km, kv};
  void* outs[8] = {o_st, o_fl, o_pr, o_ab, o_ea, o_du, o_km, o_kv};
  const long long bytes[8] = {4LL * cap,  4LL * cap,  12LL * cap,
                              12LL * cap, 12LL * cap, 4LL * cap,
                              12LL * kcap, 1LL * kcap};
  CopyTable t;
  for (int i = 0; i < 8; ++i) {
    t.src[i] = (const unsigned char*)ins[i];
    t.dst[i] = (unsigned char*)outs[i];
    t.bytes[i] = bytes[i];
  }
  t.n = 8;
  int rc = launch_multi_copy(t, s);
  if (rc != 0) return rc;
  TickCols in{(const int*)st, (const int*)fl, (const int*)pr,
              (const int*)ab, (const int*)ea, (const int*)du,
              (const int*)km, (const unsigned char*)kv};
  TickOuts out{(int*)o_st, (int*)o_fl, (int*)o_pr, (int*)o_ab,
               (int*)o_ea, (int*)o_du, (int*)o_km, (unsigned char*)o_kv};
  TickOps ops{(const int*)kind,  (const int*)row,
              (const int*)txn,   (const int*)bal,
              (const int*)exec,  (const int*)keys,
              (const int*)flags, (const int*)now,
              (const int*)prev,  (const unsigned char*)rlast,
              (const int*)kprev, (const unsigned char*)klast};
  TickScalars sc{clock, node_epoch, lane2_clean, lane2_rej, dur_local,
                 promote};
  TickResult res{(int*)code,   (int*)status,    (int*)ts,
                 (int*)chains, (int*)out_clock, (unsigned*)csum};
  if (CMD_TICK_KPAD4 && kpad == 4)
    return launch_tick<4>(in, out, cap, kcap, ops, n, kpad, sc, res, s);
  return launch_tick<0>(in, out, cap, kcap, ops, n, kpad, sc, res, s);
}
