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
// Design: ONE launch a call, no memset. Block 0 walks; blocks 1.. copy the
// eight columns into the fresh outputs; the block that finishes last (an
// atomic ticket, left at 0 again for the next call or graph replay) does
// the last-writer scatter, so it lands after every copy.
//   (a) block 0's threads gather every op's pre-batch row and kid views
//       into the chains and stage each kid slot's key and the offset of
//       the view it reads (its previous writer's, from op_kprev);
//   (b) warp 0 walks the ops in order. The op's row view and decisions are
//       scalars in registers (no array, no pointer select); only the op's
//       own kind is evaluated, and its decisions combine with & and |
//       (short-circuit forms compile to branches, each a convergence
//       barrier); lane s owns kid slot s & 7 (lanes 8.. mirror lanes 0-7,
//       so the whole warp holds the same values and never diverges) and
//       loads its key and view offset one op ahead; a PreAccept's
//       lexicographic max conflict is a three-step xor-shuffle reduction;
//       the op lanes (kind, flags, now, prev, txn, ballot, exec) are
//       prefetched 32 ops ahead, lane j holding op i + j's, and broadcast
//       by __shfl_sync; a row chained to the op just before (prev == i -
//       1) is forwarded from registers; the chains are read and written
//       16 bytes at a time; out_code / out_status / out_ts are staged in
//       shared memory and written coalesced after the walk;
//   (c) block 0 copies the chains out and folds the checksum.
// The chains, kid lanes and staged outputs (12 + 4 kpad + 2 kpad + 5 ints
// an op: 164 bytes at kpad 4, 84 KB at tier 512) sit in dynamic shared
// memory up to CMD_TICK_SMEM_MAX bytes (tier 1024 at kpad <= 5); above it
// -- tier 4096, the largest a dispatch reaches -- the walk reads and writes
// the chain output itself and the op lanes in global memory.
//
// What bounds it: the walk is serial by nature -- each op may read the
// previous op's chain, and the clock carries through every PreAccept -- so
// its time is n times one op's dependent latency (the kid view's
// shared-memory load, the shuffle reduction, a chain of integer compares
// and selects, a few hundred instructions of ONE warp, which issues at a
// fraction of an instruction a cycle), far above the bytes bound (the
// column copy plus the op lanes); the copy, in the other blocks, is the
// only bandwidth-bound part and runs beside the walk.
#include "common.cuh"

#define KMAX 8         // kid slots per op at most (a lane each, mod 8)
#define RL 12          // row lanes in a chain
#define WT 256         // threads of every block
// the chains, kid lanes and staged outputs go to dynamic shared memory up
// to this many bytes, to global memory above; can be overridden at build
// time (-DCMD_TICK_SMEM_MAX=0) to time the global side:
// tools/cmd_tick_variants.py
#ifndef CMD_TICK_SMEM_MAX
#define CMD_TICK_SMEM_MAX (200 * 1024)
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
#define FULL 0xffffffffu

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
  unsigned* ticket;   // zeroed scratch word: the blocks' finishing order
};

// three int32 lanes, compared lexicographically (signed)
struct T3 {
  int a, b, c;
};

// the walk's compares and decisions combine bools with & and |, not && and
// ||: the short-circuit forms compile to branches, each a convergence
// barrier on the walk's one dependent chain
__device__ __forceinline__ bool lt3(T3 x, T3 y) {
  return (x.a < y.a) | ((x.a == y.a) & ((x.b < y.b) | ((x.b == y.b) &
                                                       (x.c < y.c))));
}

__device__ __forceinline__ bool eq3(T3 x, T3 y) {
  return (x.a == y.a) & (x.b == y.b) & (x.c == y.c);
}

__device__ __forceinline__ T3 sel3(bool p, T3 x, T3 y) {
  return T3{p ? x.a : y.a, p ? x.b : y.b, p ? x.c : y.c};
}

__device__ __forceinline__ int wrap_inc(int x) {
  return (int)((unsigned)x + 1u);
}

// local/Node.unique_now's hlc: max(now, clock + 1), bumped past at_least's
// hlc (the epoch is max(node epoch, at_least.epoch), taken by the caller)
__device__ __forceinline__ int unique_hlc(int now, int clock, int al_hlc) {
  const int h = max(now, wrap_inc(clock));
  return al_hlc >= h ? wrap_inc(al_hlc) : h;
}

// the op lanes that do not depend on the chain: lane j of warp 0 holds op
// base + j's (zeros past n)
struct OpLanes {
  int kind, flags, now, prev;
  int t0, t1, t2, b0, b1, b2, e0, e1, e2;
};

__device__ __forceinline__ OpLanes load_lanes(const TickOps& ops, int i,
                                              int n) {
  OpLanes o{0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (i < n) {
    o.kind = ops.kind[i];
    o.flags = ops.flags[i];
    o.now = ops.now[i];
    o.prev = ops.prev[i];
    o.t0 = ops.txn[3 * i];
    o.t1 = ops.txn[3 * i + 1];
    o.t2 = ops.txn[3 * i + 2];
    o.b0 = ops.bal[3 * i];
    o.b1 = ops.bal[3 * i + 1];
    o.b2 = ops.bal[3 * i + 2];
    o.e0 = ops.exec[3 * i];
    o.e1 = ops.exec[3 * i + 1];
    o.e2 = ops.exec[3 * i + 2];
  }
  return o;
}

__device__ __forceinline__ int bcast(int v, int j) {
  return __shfl_sync(FULL, v, j);
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}

__device__ __forceinline__ void st4(int* p, int a, int b, int c, int d) {
  *reinterpret_cast<int4*>(p) = make_int4(a, b, c, d);
}

// a kid slot's view in the chains: its previous in-batch writer's
// post-value (link p * kpad + s', p clamped to n - 1), else op i's own
// pre-batch gather; an int offset into the chains
__device__ __forceinline__ int kid_at(int link, int i, int s, int n, int c,
                                      int kpad) {
  return link >= 0 ? min(link / kpad, n - 1) * c + RL + 4 * (link % kpad)
                   : i * c + RL + 4 * s;
}

// (b) the walk, warp 0 of block 0. ch: the chains (op i's view, then its
// post-values), c ints an op; keys: the kid lanes (n * kpad); kid: with
// SMEM each slot's kid_at offset (staged), else the kprev links; o_code /
// o_st / o_ts: where each op's outputs go. With SMEM the chains are in
// shared memory and read and written 16 bytes at a time. Returns the
// clock.
template <bool SMEM>
__device__ __forceinline__ int walk(int* ch, int c, int n, int kpad,
                                    const TickOps& ops, const int* keys,
                                    const int* kid, int* o_code, int* o_st,
                                    int* o_ts, const TickScalars& sc) {
  const int lane = threadIdx.x;
  const int slot = lane & (KMAX - 1);
  const bool active = slot < kpad;       // this lane mirrors a real slot
  const bool owner = lane < kpad;        // ... and writes it back
  int clk = sc.clock;
  // the row chained to the previous op: its post-values
  int r_st = 0, r_fl = 0, r_du = 0;
  T3 r_pr{0, 0, 0}, r_ab{0, 0, 0}, r_ea{0, 0, 0};
  OpLanes cur = load_lanes(ops, lane, n);
  OpLanes nxt = load_lanes(ops, 32 + lane, n);
  // this lane's kid slot of the next op: its key and view offset, loaded
  // one op ahead (the kid lanes are not written during the walk)
  int key_n = -1, at_n = 0;
  if (active) {
    key_n = keys[slot];
    at_n = SMEM ? kid[slot] : kid_at(kid[slot], 0, slot, n, c, kpad);
  }
  for (int i = 0; i < n; ++i) {
    const int j = i & 31;
    if (j == 0 && i > 0) {
      cur = nxt;
      nxt = load_lanes(ops, i + 32 + lane, n);
    }
    const int kind = bcast(cur.kind, j);
    const int f = bcast(cur.flags, j);
    const int now = bcast(cur.now, j);
    const int prev = bcast(cur.prev, j);
    const T3 txn{bcast(cur.t0, j), bcast(cur.t1, j), bcast(cur.t2, j)};
    const T3 bal{bcast(cur.b0, j), bcast(cur.b1, j), bcast(cur.b2, j)};
    const T3 oex{bcast(cur.e0, j), bcast(cur.e1, j), bcast(cur.e2, j)};

    // this lane's kid slot
    const int key = key_n, at = at_n;
    if (active && i + 1 < n) {
      const int t = (i + 1) * kpad + slot;
      key_n = keys[t];
      at_n = SMEM ? kid[t] : kid_at(kid[t], i + 1, slot, n, c, kpad);
    }
    T3 km{NEG, NEG, NEG};
    bool kvr = false;
    if (active) {
      if (SMEM) {
        const int4 v = ld4(ch + at);
        km = T3{v.x, v.y, v.z};
        kvr = v.w != 0;
      } else {
        km = T3{ch[at], ch[at + 1], ch[at + 2]};
        kvr = ch[at + 3] != 0;
      }
    }
    const bool kvm = kvr & (key >= 0);

    // the row view: the previous op's registers, else its chain slot
    int st, fl, du;
    T3 pr, ab, ea;
    if (i > 0 && prev == i - 1) {
      st = r_st;
      fl = r_fl;
      du = r_du;
      pr = r_pr;
      ab = r_ab;
      ea = r_ea;
    } else {
      const int* src = ch + (prev >= 0 ? min(prev, n - 1) : i) * c;
      if (SMEM) {
        const int4 a = ld4(src), b = ld4(src + 4), d = ld4(src + 8);
        st = a.x;
        fl = a.y;
        pr = T3{a.z, a.w, b.x};
        ab = T3{b.y, b.z, b.w};
        ea = T3{d.x, d.y, d.z};
        du = d.w;
      } else {
        st = src[0];
        fl = src[1];
        pr = T3{src[2], src[3], src[4]};
        ab = T3{src[5], src[6], src[7]};
        ea = T3{src[8], src[9], src[10]};
        du = src[11];
      }
    }

    const bool valid = (f & F_VALID) != 0;
    const bool msg_has_txn = (f & F_MSG_HAS_TXN) != 0;
    const bool deps_empty = (f & F_DEPS_EMPTY) != 0;
    const bool has_txn = (fl & 1) != 0;
    const bool terminal = (st == ST_INVALIDATED) | (st == ST_TRUNCATED);
    const int term_code =
        st == ST_INVALIDATED ? OUT_REJECTED_BALLOT : OUT_TRUNCATED;
    // the post-values (kept when the op is not valid), and what the op
    // reports: only the op's own kind is evaluated (kind is the same in
    // every lane, so the warp never diverges on it)
    int n_st = st, n_fl = fl, n_du = du, code;
    T3 n_pr = pr, n_ab = ab, n_ea = ea, ts_out, regval;
    bool ok;
    if (kind == 0) {
      // PreAccept (commands.preaccept): the kids' lexicographic max
      // conflict over the valid slots (each group of 8 lanes holds every
      // slot, so all 32 lanes end with the same max)
      bool mc_any = kvm;
      T3 mc = km;
#pragma unroll
      for (int d = 4; d > 0; d >>= 1) {
        const bool ov = __shfl_xor_sync(FULL, (int)mc_any, d) != 0;
        const T3 om{__shfl_xor_sync(FULL, mc.a, d),
                    __shfl_xor_sync(FULL, mc.b, d),
                    __shfl_xor_sync(FULL, mc.c, d)};
        mc = sel3(ov & (!mc_any | lt3(mc, om)), om, mc);
        mc_any = mc_any | ov;
      }
      const bool permit_fast = (f & F_PERMIT_FAST) != 0;
      const bool pr_gt_bal = lt3(bal, pr);
      const bool pa_blocked = terminal | pr_gt_bal;
      const T3 al = sel3(mc_any, mc, txn);
      const bool expired = (f & F_EXPIRED) != 0;
      const bool fast = permit_fast & (!mc_any | !lt3(txn, mc)) &
                        ((f & F_EPOCH_OK) != 0);
      const int h = unique_hlc(now, clk, expired ? txn.b : al.b);
      const bool keep_clk = fast & !expired;
      const T3 witness =
          keep_clk
              ? txn
              : T3{max(sc.node_epoch, expired ? txn.a : al.a), h,
                   expired ? sc.lane2_rej : sc.lane2_clean};
      const bool ea_set = ea.a != NEG;
      ok = !pa_blocked & !has_txn & !ea_set;
      code = terminal ? term_code
             : pr_gt_bal ? OUT_REJECTED_BALLOT
             : (has_txn & permit_fast) ? OUT_REDUNDANT
                                        : OUT_SUCCESS;
      ts_out = sel3(ok, witness, ea);
      regval = witness;
      n_st = (!valid | pa_blocked | has_txn) ? st
             : ea_set ? max(st, ST_PRE_ACCEPTED)
                      : ST_PRE_ACCEPTED;
      n_fl = (!valid | pa_blocked) ? fl : (fl | 1);
      n_pr = sel3(!valid | pa_blocked | !lt3(pr, bal), pr, bal);
      n_ea = sel3(valid, ts_out, ea);
      clk = (valid & ok & !keep_clk) ? h : clk;
    } else if (kind == 1) {
      // Accept (commands.accept)
      const bool pr_gt_bal = lt3(bal, pr);
      const bool committed = st >= ST_COMMITTED;
      ok = !terminal & !pr_gt_bal & !committed;
      code = terminal ? term_code
             : committed ? OUT_REDUNDANT
             : pr_gt_bal ? OUT_REJECTED_BALLOT
                         : OUT_SUCCESS;
      ts_out = sel3(ok, oex, ea);
      regval = oex;
      const bool upd = valid & ok;
      n_st = upd ? ST_ACCEPTED : st;
      n_pr = sel3(upd, bal, pr);
      n_ab = sel3(upd, bal, ab);
      n_ea = sel3(upd, oex, ea);
    } else {
      // Commit -> STABLE (commands.commit), or any kind past it: Apply ->
      // PRE_APPLIED (commands.apply)
      const bool ap = kind != 2;
      const bool done = st >= (ap ? ST_PRE_APPLIED : ST_STABLE);
      const bool incons = done & !terminal & !eq3(ea, oex);
      const bool insuf = !done & !has_txn & !msg_has_txn;
      ok = !done & !insuf;
      code = done ? OUT_REDUNDANT + (incons ? OUT_INCONSISTENT_BIT : 0)
             : insuf ? OUT_INSUFFICIENT
             : (ap & (st >= ST_STABLE)) ? OUT_WAS_STABLE_BIT
                                       : OUT_SUCCESS;
      ts_out = sel3(ok, oex, ea);
      regval = sel3(lt3(oex, txn), txn, oex);
      const bool upd = valid & ok;
      const bool promo = (sc.promote != 0) & deps_empty;
      n_st = !upd ? st
             : ap ? (promo ? ST_APPLIED : ST_PRE_APPLIED)
                  : (promo ? ST_READY : ST_STABLE);
      n_fl = (upd & msg_has_txn) ? (fl | 1) : fl;
      n_ea = sel3(upd, oex, ea);
      n_du = (upd & ap & promo) ? max(du, sc.dur_local) : du;
    }
    const bool do_reg = valid & ok;

    int* dst = ch + i * c;
    if (owner) {  // this lane's kid slot, written back
      const bool take = do_reg & (!kvm | lt3(km, regval)) & (key >= 0);
      const T3 kw = sel3(take, regval, km);
      const int kv = (kvr | do_reg) ? 1 : 0;
      int* kd = dst + RL + 4 * slot;
      if (SMEM) {
        st4(kd, kw.a, kw.b, kw.c, kv);
      } else {
        kd[0] = kw.a;
        kd[1] = kw.b;
        kd[2] = kw.c;
        kd[3] = kv;
      }
    }
    if (lane == 0) {
      if (SMEM) {
        st4(dst, n_st, n_fl, n_pr.a, n_pr.b);
        st4(dst + 4, n_pr.c, n_ab.a, n_ab.b, n_ab.c);
        st4(dst + 8, n_ea.a, n_ea.b, n_ea.c, n_du);
      } else {
        dst[0] = n_st;
        dst[1] = n_fl;
        dst[2] = n_pr.a;
        dst[3] = n_pr.b;
        dst[4] = n_pr.c;
        dst[5] = n_ab.a;
        dst[6] = n_ab.b;
        dst[7] = n_ab.c;
        dst[8] = n_ea.a;
        dst[9] = n_ea.b;
        dst[10] = n_ea.c;
        dst[11] = n_du;
      }
      o_code[i] = valid ? code : -1;
      o_st[i] = n_st;
      o_ts[3 * i] = ts_out.a;
      o_ts[3 * i + 1] = ts_out.b;
      o_ts[3 * i + 2] = ts_out.c;
    }
    r_st = n_st;
    r_fl = n_fl;
    r_pr = n_pr;
    r_ab = n_ab;
    r_ea = n_ea;
    r_du = n_du;
    __syncwarp();  // this op's chain writes before the next op's reads
  }
  return clk;
}

// the last-writer scatter into the fresh columns, from the chain output
__device__ __forceinline__ void scatter_last(const TickOuts& out, int cap,
                                             int kcap, const TickOps& ops,
                                             int n, int kpad, int c,
                                             const int* chains) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!ops.rlast[i]) continue;
    const int r = norm_index(ops.row[i], cap);
    if (r < 0) continue;
    const int* s = chains + (long long)i * c;
    out.st[r] = __ldcg(s);
    out.fl[r] = __ldcg(s + 1);
    for (int e = 0; e < 3; ++e) {
      out.pr[3LL * r + e] = __ldcg(s + 2 + e);
      out.ab[3LL * r + e] = __ldcg(s + 5 + e);
      out.ea[3LL * r + e] = __ldcg(s + 8 + e);
    }
    out.du[r] = __ldcg(s + 11);
  }
  for (int t = threadIdx.x; t < n * kpad; t += blockDim.x) {
    if (!ops.klast[t]) continue;
    const int i = t / kpad, s = t - i * kpad;
    const int k = norm_index(ops.keys[t], kcap);
    if (k < 0) continue;
    const int* v = chains + (long long)i * c + RL + 4 * s;
    for (int e = 0; e < 3; ++e) out.km[3LL * k + e] = __ldcg(v + e);
    out.kv[k] = __ldcg(v + 3) != 0 ? 1 : 0;
  }
}

// SMEM: the chains, kid lanes and staged outputs in dynamic shared memory
// (else the chain output and the op lanes in global memory)
template <bool SMEM>
__global__ void __launch_bounds__(WT)
cmd_tick_kernel(const TickCols in, const TickOuts out, int cap, int kcap,
                const TickOps ops, int n, int kpad, const TickScalars sc_in,
                const int* __restrict__ sc_dev, const TickResult res,
                const __grid_constant__ CopyTable copy) {
  extern __shared__ int smem[];
  __shared__ int s_last;
  const int c = RL + 4 * kpad;
  if (blockIdx.x > 0) {
    multi_copy_part(copy, (long long)(blockIdx.x - 1) * blockDim.x +
                              threadIdx.x,
                    (long long)(gridDim.x - 1) * blockDim.x);
  } else {
    // sc_dev (the megakernel's graph): the five scalars from device memory
    TickScalars sc = sc_in;
    if (sc_dev != nullptr) {
      sc.clock = sc_dev[0];
      sc.node_epoch = sc_dev[1];
      sc.lane2_clean = sc_dev[2];
      sc.lane2_rej = sc_dev[3];
      sc.dur_local = sc_dev[4];
    }
    int* ch = SMEM ? smem : res.chains;
    int* s_keys = smem + n * c;
    int* s_kid = s_keys + n * kpad;
    int* s_code = s_kid + n * kpad;
    int* s_st = s_code + n;
    int* s_ts = s_st + n;
    // (a) the pre-batch views, and the kid lanes
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      int r = ops.row[i];
      r = r < 0 ? 0 : (r >= cap ? cap - 1 : r);
      int* d = ch + (long long)i * c;
      d[0] = in.st[r];
      d[1] = in.fl[r];
      for (int e = 0; e < 3; ++e) {
        d[2 + e] = in.pr[3LL * r + e];
        d[5 + e] = in.ab[3LL * r + e];
        d[8 + e] = in.ea[3LL * r + e];
      }
      d[11] = in.du[r];
    }
    for (int t = threadIdx.x; t < n * kpad; t += blockDim.x) {
      const int i = t / kpad, s = t - i * kpad;
      const int key = ops.keys[t];
      const int k = key < 0 ? 0 : (key >= kcap ? kcap - 1 : key);
      int* d = ch + (long long)i * c + RL + 4 * s;
      for (int e = 0; e < 3; ++e) d[e] = in.km[3LL * k + e];
      d[3] = in.kv[k] != 0 ? 1 : 0;
      if (SMEM) {
        s_keys[t] = key;
        s_kid[t] = kid_at(ops.kprev[t], i, s, n, c, kpad);
      }
    }
    __syncthreads();
    // (b) the walk
    if (threadIdx.x < 32) {
      const int clk =
          SMEM ? walk<true>(ch, c, n, kpad, ops, s_keys, s_kid, s_code,
                            s_st, s_ts, sc)
               : walk<false>(ch, c, n, kpad, ops, ops.keys, ops.kprev,
                             res.code, res.status, res.ts, sc);
      if (threadIdx.x == 0) *res.clock = clk;
    }
    __syncthreads();
    // (c) the staged outputs and chains out; the checksum
    if (SMEM) {
      for (long long t = threadIdx.x; t < (long long)n * c; t += blockDim.x)
        res.chains[t] = smem[t];
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        res.code[i] = s_code[i];
        res.status[i] = s_st[i];
      }
      for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
        res.ts[i] = s_ts[i];
    }
    const int* f_code = SMEM ? s_code : res.code;
    const int* f_st = SMEM ? s_st : res.status;
    const int* f_ts = SMEM ? s_ts : res.ts;
    unsigned s3 = 0u, s7 = 0u, s11 = 0u;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s3 += fold_term(f_code[i], (unsigned)i, 3u);
      s7 += fold_term(f_st[i], (unsigned)i, 7u);
    }
    for (int i = threadIdx.x; i < 3 * n; i += blockDim.x)
      s11 += fold_term(f_ts[i], (unsigned)i, 11u);
    block_sum3(s3, s7, s11);
    if (threadIdx.x == 0)
      *res.csum = s3 ^ s7 ^ s11 ^ fold_term(*res.clock, 0u, 13u);
  }
  // the block that finishes last scatters the last writers over the copy
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(res.ticket, 1u) == gridDim.x - 1u;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  scatter_last(out, cap, kcap, ops, n, kpad, c, res.chains);
  if (threadIdx.x == 0) *res.ticket = 0u;
}

static inline size_t tick_smem_bytes(int n, int kpad) {
  return (size_t)n * (RL + 4 * (size_t)kpad + 2 * (size_t)kpad + 5) *
         sizeof(int);
}

// the eight input columns, the eight fresh outputs, cap, kcap; the twelve
// op lanes (kind, row i32[n]; txn, ballot, exec i32[n, 3]; keys i32[n,
// kpad]; flags, now, prev i32[n]; rlast bool[n]; kprev i32[n, kpad];
// klast bool[n, kpad]), n, kpad (1..KMAX); the scalars; the result views
// (code[n], status[n], ts[n, 3], chains[n, 12 + 4 kpad], clock, csum) and
// one zeroed scratch word (left zeroed)
static int cmd_tick_impl(
    const void* st, const void* fl, const void* pr, const void* ab,
    const void* ea, const void* du, const void* km, const void* kv,
    void* o_st, void* o_fl, void* o_pr, void* o_ab, void* o_ea, void* o_du,
    void* o_km, void* o_kv, int cap, int kcap, const void* kind,
    const void* row, const void* txn, const void* bal, const void* exec,
    const void* keys, const void* flags, const void* now, const void* prev,
    const void* rlast, const void* kprev, const void* klast, int n, int kpad,
    int clock, int node_epoch, int lane2_clean, int lane2_rej, int dur_local,
    const int* sc_dev, int promote, void* code, void* status, void* ts,
    void* chains, void* out_clock, void* csum, void* ticket, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || kpad < 1 || kpad > KMAX || cap <= 0 || kcap <= 0)
    return (int)cudaErrorInvalidValue;
  const void* ins[8] = {st, fl, pr, ab, ea, du, km, kv};
  void* outs[8] = {o_st, o_fl, o_pr, o_ab, o_ea, o_du, o_km, o_kv};
  const long long bytes[8] = {4LL * cap,  4LL * cap,  12LL * cap,
                              12LL * cap, 12LL * cap, 4LL * cap,
                              12LL * kcap, 1LL * kcap};
  CopyTable t;
  long long most = 1;
  for (int i = 0; i < 8; ++i) {
    t.src[i] = (const unsigned char*)ins[i];
    t.dst[i] = (unsigned char*)outs[i];
    t.bytes[i] = bytes[i];
    if (bytes[i] / 16 > most) most = bytes[i] / 16;
  }
  t.n = 8;
  // copy blocks: about two 16-byte vectors a thread in the widest column
  long long cb = (most + 2LL * WT - 1) / (2LL * WT);
  cb = cb < 1 ? 1 : (cb > 256 ? 256 : cb);
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
  TickResult res{(int*)code,      (int*)status,     (int*)ts,
                 (int*)chains,    (int*)out_clock,  (unsigned*)csum,
                 (unsigned*)ticket};
  const size_t need = tick_smem_bytes(n, kpad);
  const dim3 grid((unsigned)(1 + cb));
  if (need <= (size_t)CMD_TICK_SMEM_MAX) {
    if (need > 48 * 1024) {
      // once per card: the attribute holds the largest size this build uses
      static bool raised[64];
      int dev = 0;
      cudaGetDevice(&dev);
      if (!raised[dev & 63]) {
        cudaFuncSetAttribute(cmd_tick_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             CMD_TICK_SMEM_MAX);
        ACCORD_CHECK();
        raised[dev & 63] = true;
      }
    }
    cmd_tick_kernel<true><<<grid, WT, need, s>>>(in, out, cap, kcap, ops, n,
                                                 kpad, sc, sc_dev, res, t);
  } else {
    cmd_tick_kernel<false><<<grid, WT, 0, s>>>(in, out, cap, kcap, ops, n,
                                               kpad, sc, sc_dev, res, t);
  }
  ACCORD_CHECK();
  return 0;
}

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
    void* out_clock, void* csum, void* ticket, void* stream) {
  return cmd_tick_impl(st, fl, pr, ab, ea, du, km, kv, o_st, o_fl, o_pr,
                       o_ab, o_ea, o_du, o_km, o_kv, cap, kcap, kind, row,
                       txn, bal, exec, keys, flags, now, prev, rlast, kprev,
                       klast, n, kpad, clock, node_epoch, lane2_clean,
                       lane2_rej, dur_local, nullptr, promote, code, status,
                       ts, chains, out_clock, csum, ticket, stream);
}

// cmd_tick with the five scalars (clock, node_epoch, lane2_clean,
// lane2_rej, dur_local) read from device memory at `sc_dev` when the
// kernel runs: the protocol megakernel's graph replays it every tick
extern "C" int cmd_tick_dsc(
    const void* st, const void* fl, const void* pr, const void* ab,
    const void* ea, const void* du, const void* km, const void* kv,
    void* o_st, void* o_fl, void* o_pr, void* o_ab, void* o_ea, void* o_du,
    void* o_km, void* o_kv, int cap, int kcap, const void* kind,
    const void* row, const void* txn, const void* bal, const void* exec,
    const void* keys, const void* flags, const void* now, const void* prev,
    const void* rlast, const void* kprev, const void* klast, int n, int kpad,
    const void* sc_dev, int promote, void* code, void* status, void* ts,
    void* chains, void* out_clock, void* csum, void* ticket, void* stream) {
  return cmd_tick_impl(st, fl, pr, ab, ea, du, km, kv, o_st, o_fl, o_pr,
                       o_ab, o_ea, o_du, o_km, o_kv, cap, kcap, kind, row,
                       txn, bal, exec, keys, flags, now, prev, rlast, kprev,
                       klast, n, kpad, 0, 0, 0, 0, 0, (const int*)sc_dev,
                       promote, code, status, ts, chains, out_clock, csum,
                       ticket, stream);
}
