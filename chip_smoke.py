#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accord_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, small
                                       # (exercises the script; no result)

Phases, each of which fails the run (exit 1, no result line) on any error.
Each burn below is a path: every kernel's launch count is zeroed just
before it and read just after, and the kernels of that path must have
launched.
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from accord_tpu_torch/csrc (nvcc, in parallel);
  3. key burn: a 5-node cluster commits rw-register txns (4 keys, Zipf
     0.99 over 16 hot keys) through the port's BatchDepsResolver on the
     card (K1-K4 must launch); the same seed with the resolver on the CPU
     must commit the identical history, with zero host, finalize and
     checksum fallbacks;
  4. range-mix burn, this slice's path at the JAX package's range-mix
     configuration (bench.py's bench_range_mix): 5 nodes, rf 3, 10% range
     reads, 10% range writes, durability rounds every 1000 ms (range sync
     points); card vs CPU identical history, lost 0, zero host, range and
     checksum fallbacks, the finalize and legacy-decode counts equal to
     the CPU leg's (at this seed both packages trip the same few sequence
     guards: registrations that widen a row or free range rows while a
     call is in flight, which the mutation fence does not cover), range
     subjects decoded on the device, and K4's range entry, K5 and K6
     launched;
  5. inline leg: no batch window (the JAX package's inline range-read
     differential), card vs CPU identical, the max_conflict kernel (K7)
     launched;
  6. the PreAccept batch: 10,000 in-flight writes over 1,000 keys, 4,096
     subjects through the async pipeline, every answer equal to the host
     scan; then the same with 1,024 in-flight range writes added and 20%
     range subjects (the shape at which K5 and K6 do real work);
  7. exec burn, fused: bench.py's bench_exec_plane leg (seed 31, Zipf 0.99
     over 16 hot keys, durability every 1000 ms, two stores per node, host
     deps) with the port's exec planes PRIMARY on the card (releases only
     from harvested frontiers; the host WaitingOn asserts each one): card
     vs CPU identical history, lost 0, every exec plane and coordinator
     counter equal, granular ts/flags uploads > 0 and the upload bytes
     below the whole-row baseline; exec_scatter (K8) and the fused
     frontier (K9) launched;
  8. exec burn, compacted: the same with frontier_compact harvests and the
     port's BatchDepsResolver on the card too (deps and execution both on
     the device): card vs CPU identical, zero compact fallbacks, overflows
     and every counter equal to the CPU leg's; frontier_compact launched;
  9. exec solo leg: one store per node, so each plane runs the plain
     execution_frontier; card vs CPU identical;
 10. exec frontier batch, the kernels at their largest: (a) bench.py's
     10k-in-flight compact harvest (5 planes x 2048 rows, all pending, 40
     released per plane) through frontier_compact and
     fused_execution_frontier, every released set the expected one; (b)
     one 16384-row plane with ~10,000 pending rows waiting on up to 8
     earlier rows each, signed exec_ts with ~10% undecided, ~5% awaits_all
     and half the rest applied: a 64-row exec_scatter, then
     execution_frontier and frontier_compact, equal to the plain versions;
 11. cmd burn: the key burn's cluster (5 nodes, rf 3, Zipf 0.99 over 16
     hot keys, 4-key txns: owned keys fill KPAD = 4) with the resolver AND
     the command planes on the card (every replica's PreAccept witness,
     Accept ballot checks, Commit/Apply promotions through cmd_tick, K10),
     400 ops: card vs CPU identical history, every cmd_plane_* counter
     equal, zero checksum mismatches, cmd_tick launched exactly once per
     cmd_plane dispatch;
 12. authoritative + recovery leg: bench.py's bench_recovery_storm storm
     config through run_burn (seed 17, 48 ops, 4 nodes, rf 3, 2 stores per
     node, 24 keys, concurrency 8, crash-restart; no megakernel), planes
     authoritative (cmd_tick with promote), recovery candidates by ONE
     recovery_scan query per progress sweep (K11), 5% drops and a 300 ms
     stall so the scan finds candidates: card vs CPU identical, equal to
     the host-scan run, candidates > 0, zero scan fallbacks and overflows
     (no scan answered by the host), every counter equal to the CPU leg's;
 13. repair leg: tests/test_megakernel.py's defer_batch script on a card
     plane (fresh PreAccepts; redundant re-delivery with ballot
     contention; a commit mid-batch), then collect_repair -> cmd_repair
     (K12) -> adopt_repair: the columns equal a twin plane's after a plain
     flush, and a following eval_batch answers identically;
 14. cmd batch at 10k in flight (bench.py's bench_cmd_plane streams:
     10,000 txns of 1-3 keys over 256, arena cap 16384, 512-op dispatches,
     arena-only with promote): the PreAccept -> Commit -> Apply decision
     history on the card equals the Python handlers', every row APPLIED at
     the handlers' executeAt, zero fallbacks; committed txn/s of both;
 15. recovery batch (bench_recovery_storm's scan leg): 10,240 rows, the
     last third APPLIED, stall ages from default_rng(29), stall 1000 ms;
     after one warm sweep every scan at now0 + 0/20/40/60 equals
     recovery_scan_host and a python walk, one dispatch per scan, zero
     fallbacks and overflows;
 16. kernels: each kernel's wrapper is called again on the card on the
     exact inputs its path (and a batch) gave it, and held bit-equal
     against its plain PyTorch version on the same inputs; kernel, plain
     and (where one exists) single-library-call times come from CUDA
     events, and each call's bound from the bytes it must move (3.35 TB/s)
     or the operations it must do (67 T 32-bit op/s). cmd_tick is replayed
     on a tier-8 dispatch of the cmd burn and a tier-512 dispatch of the
     cmd batch, with its time per op (the walk is serial).
The last three lines are the card line, one JSON line of kernels, and the
result line {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
INT32_OPS_PER_S = 67e12          # 32-bit ops outside the tensor cores
KERNELS = (
    ("deps_resolve", "accord_tpu_torch/csrc/deps_resolve.cu",
     "accord_tpu/ops/kernels.py:268"),
    ("finalize_csr", "accord_tpu_torch/csrc/finalize_csr.cu",
     "accord_tpu/ops/kernels.py:697"),
    ("arena_scatter", "accord_tpu_torch/csrc/arena_scatter.cu",
     "accord_tpu/ops/kernels.py:822"),
    ("row_scatter", "accord_tpu_torch/csrc/row_scatter.cu",
     "accord_tpu/ops/kernels.py:242"),
    ("range_scatter", "accord_tpu_torch/csrc/row_scatter.cu",
     "accord_tpu/ops/kernels.py:852"),
    ("range_resolve", "accord_tpu_torch/csrc/range_resolve.cu",
     "accord_tpu/ops/kernels.py:415"),
    ("range_finalize", "accord_tpu_torch/csrc/range_finalize.cu",
     "accord_tpu/ops/kernels.py:766"),
    ("max_conflict", "accord_tpu_torch/csrc/max_conflict.cu",
     "accord_tpu/ops/kernels.py:65"),
    ("exec_scatter", "accord_tpu_torch/csrc/exec_scatter.cu",
     "accord_tpu/ops/kernels.py:224"),
    ("execution_frontier", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:143"),
    ("fused_execution_frontier", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:174"),
    ("frontier_compact", "accord_tpu_torch/csrc/exec_frontier.cu",
     "accord_tpu/ops/kernels.py:651"),
    ("cmd_tick", "accord_tpu_torch/csrc/cmd_tick.cu",
     "accord_tpu/ops/kernels.py:1032"),
    ("recovery_scan", "accord_tpu_torch/csrc/recovery_scan.cu",
     "accord_tpu/ops/kernels.py:682"),
    ("cmd_repair", "accord_tpu_torch/csrc/cmd_repair.cu",
     "accord_tpu/ops/kernels.py:1347"),
)
EXEC_KERNELS = ("exec_scatter", "execution_frontier",
                "fused_execution_frontier", "frontier_compact")
# kernel-module functions recorded on the paths, by kernel
RECORDED = {"deps_resolve": ("deps_resolve", "fused_deps_resolve"),
            "finalize_csr": ("finalize_csr",),
            "arena_scatter": ("arena_scatter", "arena_scatter_keys"),
            "row_scatter": ("scatter_rows", "kid_word_scatter",
                            "arena_grow"),
            "range_scatter": ("range_scatter",),
            "range_resolve": ("range_deps_resolve",
                              "fused_range_deps_resolve", "covered_buckets"),
            "range_finalize": ("range_finalize_csr", "segment_compact"),
            "max_conflict": ("max_conflict",),
            **{k: (k,) for k in EXEC_KERNELS},
            "cmd_tick": ("cmd_tick",), "recovery_scan": ("recovery_scan",),
            "cmd_repair": ("cmd_repair",)}
# the path whose launches each kernel's entry reports
PATH_OF = {"deps_resolve": "key_burn", "finalize_csr": "key_burn",
           "arena_scatter": "key_burn", "row_scatter": "key_burn",
           "range_scatter": "range_burn", "range_resolve": "range_burn",
           "range_finalize": "range_burn", "max_conflict": "inline",
           "exec_scatter": "exec_burn", "execution_frontier": "exec_solo",
           "fused_execution_frontier": "exec_burn",
           "frontier_compact": "exec_compact", "cmd_tick": "cmd_burn",
           "recovery_scan": "recovery_burn", "cmd_repair": "repair"}


class SmokeFailure(Exception):
    pass


def log(*a) -> None:
    print(*a, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# -- recording the main path's kernel inputs ---------------------------------
class Recorder:
    """Wraps the kernel module's public functions (the resolver imports
    them at call time) and keeps, per function, the arguments of its
    largest call, so the kernel phase replays exactly what the path gave
    each kernel. `cmd_tier` keeps cmd_tick's first call at that op tier
    instead. `promoted` counts cmd_tick's calls with promote on. Recording
    launches nothing itself."""

    def __init__(self, tk, cmd_tier=None):
        self.tk = tk
        self.calls = {}
        self.orig = {}
        self.cmd_tier = cmd_tier
        self.promoted = 0

    def __enter__(self):
        import torch
        for names in RECORDED.values():
            for name in names:
                fn = getattr(self.tk, name)
                self.orig[name] = fn

                def wrapped(*args, _fn=fn, _name=name, **kw):
                    size = sum(a.numel() for a in _flat(args)
                               if torch.is_tensor(a))
                    best = self.calls.get(_name)
                    if _name == "cmd_tick":
                        self.promoted += bool(kw.get("promote"))
                        if self.cmd_tier is not None:
                            if best is None \
                                    and args[9].shape[0] == self.cmd_tier:
                                self.calls[_name] = (size, args, kw)
                            return _fn(*args, **kw)
                    if best is None or size > best[0]:
                        self.calls[_name] = (size, args, kw)
                    return _fn(*args, **kw)

                setattr(self.tk, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.tk, name, fn)

    def get(self, name):
        c = self.calls.get(name)
        return None if c is None else (c[1], c[2])


def _flat(xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flat(x)
        else:
            yield x


# -- timing and comparison ---------------------------------------------------
def time_ms(fn, iters: int, cuda: bool) -> float:
    import torch
    fn()
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest |kernel - plain| over every output (0 means bit-equal; the
    outputs are integers and bit words)."""
    import torch
    ta = [t for t in _flat(a if isinstance(a, tuple) else (a,))]
    tb = [t for t in _flat(b if isinstance(b, tuple) else (b,))]
    check(len(ta) == len(tb), "output arity differs")
    worst = 0
    for x, y in zip(ta, tb):
        check(x.shape == y.shape and x.dtype == y.dtype,
              f"output shape/dtype differs: {x.shape} {x.dtype} vs "
              f"{y.shape} {y.dtype}")
        if x.numel():
            d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
            worst = max(worst, int(d))
    return worst


def nbytes(*ts) -> int:
    import torch
    return sum(t.numel() * t.element_size() for t in _flat(ts)
               if torch.is_tensor(t))


# -- per-kernel work: replay, compare, time, bound ---------------------------
def kernel_report(tk, name: str, rec: Recorder, cuda: bool, iters: int):
    """Replay each recorded call of `name`'s wrappers on the card: kernel
    vs plain (bit-equal), each timed. The call with the largest inputs is
    the kernel's headline; every call's row is kept. Three wrappers the
    path does not call on their own replay on inputs derived from a
    recorded call: arena_grow on the recorded arena_scatter's lanes,
    doubled; arena_scatter_keys on its bitmap and CSR; covered_buckets on the recorded range query's interval CSR
    (K5 runs the same pass inside); segment_compact on the stab words of
    the recorded range_finalize_csr call (K6 runs the same passes)."""
    plain_of = {
        "deps_resolve": tk.deps_resolve_plain,
        "fused_deps_resolve": tk.fused_deps_resolve_plain,
        "finalize_csr": tk.finalize_csr_plain,
        "arena_scatter": tk.arena_scatter_plain,
        "arena_scatter_keys": tk.arena_scatter_keys_plain,
        "scatter_rows": tk._scatter_lane_plain,
        "kid_word_scatter": tk.kid_word_scatter_plain,
        "arena_grow": tk.arena_grow_plain,
        "range_scatter": tk.range_scatter_plain,
        "range_deps_resolve": tk.range_deps_resolve_plain,
        "fused_range_deps_resolve": tk.fused_range_deps_resolve_plain,
        "covered_buckets": tk.covered_buckets_plain,
        "range_finalize_csr": tk.range_finalize_csr_plain,
        "segment_compact": tk.segment_compact_plain,
        "max_conflict": tk.max_conflict_plain,
        "exec_scatter": tk.exec_scatter_plain,
        "execution_frontier": tk.execution_frontier_plain,
        "fused_execution_frontier": tk.fused_execution_frontier_plain,
        "frontier_compact": tk.frontier_compact_plain,
        "cmd_tick": tk.cmd_tick_plain,
        "recovery_scan": tk.recovery_scan_plain,
        "cmd_repair": tk.cmd_repair_plain,
    }
    calls = []
    for fn_name in RECORDED[name]:
        got = rec.get(fn_name)
        if got is None:
            got = derived_call(tk, fn_name, rec)
        if got is not None:
            calls.append((fn_name, *got))
    check(calls, f"{name}: no recorded call to replay")
    rows = []
    for fn_name, args, kw in calls:
        kern = getattr(tk, fn_name)
        plain = plain_of[fn_name]
        out = kern(*args, **kw)
        err = max_abs_err(out, plain(*args, **kw))
        ms = time_ms(lambda: kern(*args, **kw), iters, cuda)
        plain_ms = time_ms(lambda: plain(*args, **kw), max(1, iters // 10),
                           cuda)
        bytes_, ops, library = bound_inputs(tk, fn_name, args, kw, out)
        t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / INT32_OPS_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        row = {"call": fn_name, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "share": bound_ms / ms if ms > 0 else None,
               "bytes": bytes_, "ops": ops,
               "library_ms": (time_ms(library, iters, cuda)
                              if library is not None else None),
               "input_mb": nbytes(args) / 1e6}
        if fn_name == "cmd_tick":
            # the walk is serial: its time per op, beside the bytes bound
            row["op_tier"] = int(args[9].shape[0])
            row["ms_per_op"] = ms / row["op_tier"]
            row["promote"] = bool(kw.get("promote"))
        log(f"  {json.dumps(row)}")
        rows.append(row)
    head = max(rows, key=lambda r: r["input_mb"])
    return dict(head, max_abs_err=max(r["max_abs_err"] for r in rows),
                calls=rows)


def derived_call(tk, fn_name, rec):
    """(args, kwargs) for a wrapper the path does not call on its own,
    from the recorded call that runs the same passes (see kernel_report),
    or None."""
    if fn_name in ("arena_grow", "arena_scatter_keys"):
        lanes = rec.get("arena_scatter")
        if lanes is not None:
            args = lanes[0]
            if fn_name == "arena_scatter_keys":
                return (args[0], args[5], args[6], args[7]), {}
            return args[:5], {"new_cap": 2 * args[0].shape[0]}
    if fn_name == "covered_buckets":
        for src in ("range_deps_resolve", "fused_range_deps_resolve"):
            got = rec.get(src)
            if got is None:
                continue
            args = got[0]
            if src == "range_deps_resolve":
                k_bm, sb = args[11], args[3]
            else:
                karenas, sb = args[10], args[4]
                if not karenas:
                    continue
                k_bm = karenas[0][0]
            return (args[0], args[1], args[2], sb.shape[0],
                    k_bm.shape[1] * 32), {}
    if fn_name == "segment_compact":
        got = rec.get("range_finalize_csr")
        if got is not None:
            args, kw = got
            m, _ = tk.range_stab_words_plain(*args)
            return (m, kw["out_cap"]), {}
    return None


def bound_inputs(tk, fn_name, args, kw, out):
    """(bytes the function must move, 32-bit operations it must do, one
    library call computing the same function or None) for this call's
    inputs: each input read once, each output written once."""
    import torch
    if fn_name in ("deps_resolve", "fused_deps_resolve"):
        if fn_name == "deps_resolve":
            subj_of, subj_keys, sb, sknd, bm, ts, kinds, valid, table = args
            blocks, mines = [(bm, ts, kinds, valid)], [None]
        else:
            subj_of, subj_keys, store, sb, sknd, slots, blocks, table = args
            mines = [store == slots[s] for s in range(len(blocks))]
        # the AND work this data needs: pairs whose cheap masks pass
        nk = table.shape[0]
        pairs = 0
        for (bm, ts, kinds, valid), mine in zip(blocks, mines):
            w = table[tk._gather_index(sknd, nk)[:, None],
                      tk._gather_index(kinds, nk)[None, :]] == 1
            m = w & tk._lex_before(ts[None], sb[:, None]) & valid[None]
            if mine is not None:
                m &= mine[:, None]
            pairs += int(m.sum())
        nw = blocks[0][0].shape[1]
        ops = 2 * pairs * nw
        bytes_ = nbytes(args) + nbytes(out)
        return bytes_, ops, None
    if fn_name == "finalize_csr":
        packed, word_off, kid_rows, slot_subj, slot_kid, subj_row, act_ts = \
            args
        kc, w = kid_rows.shape
        kids = torch.unique(slot_kid[(slot_kid >= 0) & (slot_kid < kc)])
        b = packed.shape[0]
        bytes_ = (b * w * 4 + kids.numel() * w * 4
                  + nbytes(slot_subj, slot_kid, subj_row, act_ts)
                  + nbytes(out))
        ops = 3 * slot_subj.numel() * w
        return bytes_, ops, None
    if fn_name in ("range_deps_resolve", "fused_range_deps_resolve"):
        if fn_name == "range_deps_resolve":
            (iv_of, iv_s, iv_e, sb, sknd, srng, r_start, r_end, r_ts,
             r_kinds, r_valid, k_bm, k_ts, k_kinds, k_valid, table) = args
            rblocks = [(r_start, r_end, r_ts, r_kinds, r_valid)]
            kblocks = [(k_bm, k_ts, k_kinds, k_valid)]
            kmines = [srng]
        else:
            (iv_of, iv_s, iv_e, store, sb, sknd, srng, r_slots, rblocks,
             k_slots, kblocks, table) = args
            kmines = [(store == k_slots[s]) & srng
                      for s in range(len(kblocks))]
        nv = iv_of.shape[0]
        ops = 4 * nv * sum(r[0].shape[0] for r in rblocks)
        nk = table.shape[0]
        pairs = 0
        for (bm, ts, kinds, valid), mine in zip(kblocks, kmines):
            w = table[tk._gather_index(sknd, nk)[:, None],
                      tk._gather_index(kinds, nk)[None, :]] == 1
            m = w & tk._lex_before(ts[None], sb[:, None]) & valid[None] \
                & mine[:, None]
            pairs += int(m.sum())
        if kblocks:
            ops += 2 * pairs * kblocks[0][0].shape[1]
        return nbytes(args) + nbytes(out), ops, None
    if fn_name == "covered_buckets":
        iv_of, iv_s, iv_e, b, k = args
        return (nbytes(iv_of, iv_s, iv_e) + nbytes(out),
                2 * iv_of.shape[0] * k, None)
    if fn_name == "range_finalize_csr":
        iv_of, iv_s, iv_e, ent_ok = args[:4]
        r_start = args[6]
        nv, rcap = iv_of.shape[0], r_start.shape[0]
        # the stab matrix read once (as bits), the lanes, the outputs
        bytes_ = nv * rcap // 8 + nbytes(args) + nbytes(out)
        return bytes_, 4 * nv * rcap, None
    if fn_name == "segment_compact":
        return nbytes(args) + nbytes(out), 0, None
    if fn_name == "max_conflict":
        subj, bm, ex, valid = args
        # the word ANDs the data needs (a row stops at its first meeting
        # word) over valid rows, then 3 lane compares per overlapping row
        meet = (subj[:, None, :] & bm[None, :, :]) != 0
        first = torch.where(meet.any(-1),
                            meet.to(torch.int8).argmax(-1) + 1,
                            torch.full(meet.shape[:2], bm.shape[1],
                                       device=bm.device))
        ands = int((first * valid[None, :]).sum())
        overlaps = int((meet.any(-1) & valid[None, :]).sum())
        return nbytes(args) + nbytes(out), ands + 3 * overlaps, None
    if fn_name in ("execution_frontier", "fused_execution_frontier",
                   "frontier_compact"):
        planes = ((args,) if fn_name == "execution_frontier" else args[0])
        # the pending rows' adjacency read once (the kernel skips the
        # others), 15 bytes of lanes per row, the outputs written; one
        # and-not per pending row word
        bytes_, ops = nbytes(out), 0
        for adj, _ts, _app, pending, _aw in planes:
            cap, w = adj.shape
            npend = int(pending.sum())
            bytes_ += npend * w * 4 + 15 * cap
            ops += npend * w
        return bytes_, ops, None
    if fn_name == "cmd_repair":
        # the eight drop-mode scatters as eight index_copy calls on the
        # in-range indices (filtered here, outside the timed call)
        cols, (ridx, *rvals), (kidx, km_v, kv_v) = \
            args[:8], args[8:15], args[15:]
        rok = tk._norm_index(ridx, cols[0].shape[0])[1]
        kok = tk._norm_index(kidx, cols[6].shape[0])[1]
        r64, k64 = ridx[rok].to(torch.int64), kidx[kok].to(torch.int64)
        vals = [v[rok] for v in rvals] + [km_v[kok], kv_v[kok]]
        idxs = [r64] * 6 + [k64] * 2

        def lib():
            return [torch.index_copy(c, 0, i, v)
                    for c, i, v in zip(cols, idxs, vals)]
        return nbytes(args) + nbytes(out), 0, lib
    if fn_name == "scatter_rows":
        dst, idx, rows = args
        lib = None
        ni = tk._norm_index(idx, dst.shape[0])[1]
        if bool(ni.all()):
            idx64 = idx.to(torch.int64)
            lib = (lambda: torch.index_copy(dst, 0, idx64, rows))
        return nbytes(args) + nbytes(out), 0, lib
    return nbytes(args) + nbytes(kw.values()) + nbytes(out), 0, None


# -- phases ------------------------------------------------------------------
def card_line(cuda: bool) -> str:
    if not cuda:
        return "cpu rehearsal"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def build_phase() -> float:
    from accord_tpu_torch.ops import _ext
    t0 = time.perf_counter()
    for stem in sorted(_ext.build()):
        _ext.lib(stem)
    for stem, text in sorted(_ext.ptxas_log.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {stem}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers, {spills} bytes spilled")
    return time.perf_counter() - t0


def burn(device: str, ops: int, resolvers: list, seed: int = 9, **extra):
    """The key burn; `extra` adds ClusterConfig options (the cmd burn's
    command planes)."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = BatchDepsResolver(num_buckets=1024, initial_cap=2048,
                              max_dispatch=256, device=device)
        resolvers.append(r)
        return r

    cfg = ClusterConfig(num_nodes=5, rf=3, deps_resolver_factory=factory,
                        deps_batch_window_ms=16.0, device_latency_ms=80.0,
                        timeout_ms=8000.0, preaccept_timeout_ms=8000.0,
                        progress_stall_ms=5000.0, **extra)
    t0 = time.perf_counter()
    rep = run_burn(seed, ops=ops, key_count=16, zipf_theta=0.99,
                   max_keys_per_txn=4, concurrency=1024, write_ratio=0.7,
                   config=cfg, collect_log=True)
    return rep, time.perf_counter() - t0


def range_mix_burn(device: str, ops: int, resolvers: list, seed: int = 21):
    """bench.py's bench_range_mix leg, unchanged: 5 nodes, rf 3, two
    stores per node, Zipf 0.99 over 16 hot keys, 10% range reads and 10%
    range writes, durability rounds every 1000 ms."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = BatchDepsResolver(num_buckets=1024, initial_cap=2048,
                              max_dispatch=256, device=device)
        resolvers.append(r)
        return r

    cfg = ClusterConfig(num_nodes=5, rf=3, deps_resolver_factory=factory,
                        deps_batch_window_ms=2.0, device_latency_ms=8.0,
                        device_poll_ms=1.0, durability=True,
                        durability_interval_ms=1000.0, timeout_ms=8000.0,
                        preaccept_timeout_ms=8000.0,
                        progress_stall_ms=5000.0)
    t0 = time.perf_counter()
    rep = run_burn(seed, ops=ops, key_count=16, zipf_theta=0.99,
                   write_ratio=0.6, range_read_ratio=0.1,
                   range_write_ratio=0.1, collect_log=True, config=cfg)
    return rep, time.perf_counter() - t0


def inline_burn(device: str, resolvers: list):
    """tests/test_ranges.py's inline range-read differential: no batch
    window, so deps resolve synchronously and max_conflict runs on the
    device."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def factory():
        r = BatchDepsResolver(num_buckets=128, device=device)
        resolvers.append(r)
        return r

    t0 = time.perf_counter()
    rep = run_burn(11, ops=80, range_read_ratio=0.25, collect_log=True,
                   config=ClusterConfig(deps_resolver_factory=factory,
                                        deps_batch_window_ms=None))
    return rep, time.perf_counter() - t0


def exec_burn(device: str, ops: int, stores: int = 2, compact: bool = False,
              resolvers=None):
    """bench.py's bench_exec_plane leg, unchanged: seed 31, Zipf 0.99 over
    16 hot keys, durability rounds every 1000 ms, the exec planes primary
    on `device` (two stores per node: the ExecCoordinator fuses their
    frontiers), host deps. `compact` harvests through frontier_compact;
    `resolvers` (a list) puts the port's BatchDepsResolver on the same
    device."""
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    cfg = dict(exec_plane=True, exec_device=device, exec_compact=compact,
               stores_per_node=stores, durability=True,
               durability_interval_ms=1000.0)
    if resolvers is not None:
        def factory():
            r = BatchDepsResolver(num_buckets=1024, initial_cap=2048,
                                  max_dispatch=256, device=device)
            resolvers.append(r)
            return r
        cfg.update(deps_resolver_factory=factory, deps_batch_window_ms=2.0)
    t0 = time.perf_counter()
    rep = run_burn(31, ops=ops, key_count=16, zipf_theta=0.99,
                   collect_log=True, config=ClusterConfig(**cfg))
    return rep, time.perf_counter() - t0


def cmd_counters(rep) -> dict:
    """Every command-plane and recovery-scan counter of a burn, summed over
    planes (the wall-clock timers left out)."""
    return {k: v for k, v in rep.counters.items()
            if k.startswith(("cmd_", "recovery_scan_"))
            and not k.endswith("_s")}


def recovery_burn(device: str, scan: str):
    """bench.py's bench_recovery_storm storm config through run_burn, no
    megakernel: seed 17, 48 ops, 4 nodes, rf 3, two stores per node, 24
    keys, concurrency 8, crash-restart, the command planes authoritative
    on `device`; 5% message drops and a 300 ms progress stall, so the
    recovery scan (`scan`: "host" or "device") returns candidates."""
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    cfg = ClusterConfig(num_nodes=4, rf=3, stores_per_node=2,
                        cmd_plane=True, cmd_device=device,
                        cmd_plane_authoritative=True, recovery_scan=scan,
                        progress_stall_ms=300.0)
    t0 = time.perf_counter()
    rep = run_burn(17, ops=48, key_count=24, concurrency=8,
                   crash_restart=True, chaos_drop=0.05, collect_log=True,
                   config=cfg)
    return rep, time.perf_counter() - t0


def _one_store(device=None):
    """A one-node, one-store cluster (no progress engine); with `device`,
    its store carries a command plane there."""
    from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig
    extra = {} if device is None else dict(cmd_plane=True, cmd_device=device)
    cluster = Cluster(1, ClusterConfig(num_nodes=1, rf=1, num_shards=1,
                                       stores_per_node=1, progress=False,
                                       **extra))
    node = cluster.nodes[1]
    return cluster, node, node.command_stores.stores[0]


def _write_txn(keys, value):
    from accord_tpu_torch.primitives.keyspace import Keys
    from accord_tpu_torch.primitives.timestamp import TxnKind
    from accord_tpu_torch.primitives.txn import Txn
    from accord_tpu_torch.sim.list_store import (ListQuery, ListRead,
                                                 ListUpdate)
    k = Keys(sorted(keys))
    return Txn(TxnKind.WRITE, k, read=ListRead(k),
               update=ListUpdate(k, value), query=ListQuery())


def _twin_spans(device: str, defer: bool, after=None):
    """tests/test_megakernel.py's defer_batch script on a plane on
    `device`: fresh PreAccepts; redundant re-delivery with ballot
    contention; a commit mid-batch. With `after`, the device columns are
    built first and `after(plane)` runs after each of the three spans.
    -> (results, plane)."""
    from accord_tpu_torch.ops.cmd_plane import CmdOp
    from accord_tpu_torch.primitives.deps import Deps
    from accord_tpu_torch.primitives.timestamp import Ballot
    _cluster, node, store = _one_store(device)
    plane = store.cmd_plane
    txns = []
    for i in range(6):
        txn = _write_txn([1 + (i % 4), 5], i + 1)
        tid = node.next_txn_id(txn.kind, txn.domain)
        txns.append((tid, txn, node.compute_route(txn)))

    def part(t):
        return t.slice(store.ranges, include_query=False)

    if after is not None:
        plane._flush()    # the device columns live before the first span
    ev = ((lambda b: plane.defer_batch(b, sink=lambda *_: None)) if defer
          else plane.eval_batch)
    out = []
    for batch in (
            [CmdOp.preaccept(t, part(x), r) for t, x, r in txns[:4]],
            [CmdOp.preaccept(txns[0][0], part(txns[0][1]), txns[0][2]),
             CmdOp.preaccept(txns[1][0], part(txns[1][1]), txns[1][2],
                             Ballot(1, 5, 0, 1)),
             CmdOp.preaccept(txns[4][0], part(txns[4][1]), txns[4][2])],
            None):
        if batch is None:
            ea = store.command_if_present(txns[2][0]).execute_at
            batch = [
                CmdOp.preaccept(txns[5][0], part(txns[5][1]), txns[5][2]),
                CmdOp.commit(txns[2][0], txns[2][2], part(txns[2][1]), ea,
                             Deps.NONE),
                CmdOp.preaccept(txns[3][0], part(txns[3][1]), txns[3][2],
                                Ballot(1, 2, 0, 1))]
        out.append([(r.outcome, r.status, r.execute_at) for r in ev(batch)])
        if after is not None:
            after(plane)
    return out, plane


def repair_leg(device: str) -> dict:
    """The defer_batch script twice on `device`; after each span one plane
    retires its flush debt through collect_repair -> kernels.cmd_repair
    -> adopt_repair, the twin through a plain _flush(): equal columns
    after every span, and a following eval_batch answers identically on
    both. The answers equal eval_batch's on a third plane."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.cmd_plane import CmdOp
    repaired, flushed, sizes = [], [], []

    def snapshot(plane):
        return {k: v.cpu() for k, v in plane._device.items()}

    def repair(plane):
        got = plane.collect_repair()
        check(got not in (None, "clean"),
              f"repair leg: nothing to repair ({got})")
        block, meta = got
        plane.adopt_repair(tk.cmd_repair(*block), meta, spans=1)
        check(plane.collect_repair() == "clean",
              "repair leg: rows still dirty after adopt_repair")
        sizes.append((len(meta[0]), len(meta[1])))
        repaired.append(snapshot(plane))

    def flush(plane):
        plane._flush()
        flushed.append(snapshot(plane))

    out_r, plane_r = _twin_spans(device, defer=True, after=repair)
    out_t, plane_t = _twin_spans(device, defer=True, after=flush)
    out_e, _plane_e = _twin_spans(device, defer=False)
    check(out_r == out_t == out_e, "repair leg: defer_batch answered "
          "differently from eval_batch")
    for span, (a, b) in enumerate(zip(repaired, flushed)):
        for name in a:
            check(torch.equal(a[name], b[name]),
                  f"repair leg: column {name} after span {span} differs "
                  "from the flushed twin's")
    check(any(k for _r, k in sizes), "repair leg: no kid was repaired")

    def follow(plane):
        store = plane.store
        node = store.node
        txn = _write_txn([1, 5], 99)
        tid = node.next_txn_id(txn.kind, txn.domain)
        part = txn.slice(store.ranges, include_query=False)
        res = plane.eval_batch([CmdOp.preaccept(tid, part,
                                                node.compute_route(txn))])
        return [(r.outcome, r.status, r.execute_at) for r in res]

    check(follow(plane_r) == follow(plane_t),
          "repair leg: the following eval_batch answered differently")
    return {"repairs": sizes, "deferred_spans": int(plane_r.deferred_spans),
            "retired": int(plane_r.defer_retired),
            "dispatches": int(plane_r.dispatches)}


def _cmd_stream(node, store, n: int, seed: int):
    """n write txns of 1-3 keys over 256 (bench.py's streams), ids minted
    up front: (txn id, route, the store's slice)."""
    import random
    rng = random.Random(seed)
    out = []
    for v in range(n):
        txn = _write_txn(rng.sample(range(1, 257), rng.randint(1, 3)), v)
        tid = node.next_txn_id(txn.kind, txn.domain)
        out.append((tid, node.compute_route(txn),
                    txn.slice(store.ranges, include_query=False)))
    return out


def cmd_batch(device: str, n: int) -> dict:
    """bench.py's bench_cmd_plane at n in flight: the Python handlers (the
    store entry points) vs an arena-only plane on `device` (cmd_tick with
    promote, 512-op dispatches, arena cap 16384): PreAccept -> Commit ->
    Apply decision histories equal, every row APPLIED at the handlers'
    final executeAt, zero fallbacks."""
    import torch
    from accord_tpu_torch.ops import cmd_plane as cp
    from accord_tpu_torch.ops.cmd_plane import CmdOp, CmdPlane
    from accord_tpu_torch.ops.kernels import CMD_ST_APPLIED
    from accord_tpu_torch.primitives.deps import Deps
    chunk, arena_cap = 512, 16_384
    _hc, hnode, hstore = _one_store()
    htxns = _cmd_stream(hnode, hstore, n, 11)
    hist_host, eas = [], {}
    t0 = time.perf_counter()
    for tid, route, part in htxns:
        got = {}
        hstore.submit_preaccept(tid, part, route) \
            .on_success(lambda v, g=got: g.update(v=v))
        ea = hstore.command(tid).execute_at
        eas[tid] = ea
        hist_host.append(("pa", got["v"][0], ea))
    for tid, route, part in htxns:
        out = hstore.commit_op(tid, route, part, eas[tid], Deps.NONE)
        hist_host.append(("cm", out, hstore.command(tid).execute_at))
    host_committed_s = time.perf_counter() - t0
    for tid, route, part in htxns:
        out = hstore.apply_op(tid, route, part, eas[tid], Deps.NONE, None,
                              None)
        hist_host.append(("ap", out, hstore.command(tid).execute_at))
    host_final = {tid: hstore.command(tid).execute_at for tid, *_ in htxns}

    _dc, dnode, dstore = _one_store()
    dtxns = _cmd_stream(dnode, dstore, n, 11)
    check([t[0] for t in dtxns] == [t[0] for t in htxns],
          "cmd batch: the legs minted different txn ids")
    plane = CmdPlane(dstore, initial_cap=arena_cap, key_cap=1024, kpad=4,
                     apply_to_store=False, device=device)
    hist_dev, deas = [], {}
    span_s = {}

    def phase(tag, mk_op):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, n, chunk):
            span = dtxns[i:i + chunk]
            res = plane.eval_batch([mk_op(*t) for t in span])
            for (tid, *_), r in zip(span, res):
                if tag == "pa":
                    deas[tid] = r.execute_at
                hist_dev.append((tag, r.outcome, r.execute_at))
        span_s[tag] = time.perf_counter() - t0

    phase("pa", lambda tid, route, part: CmdOp.preaccept(tid, part, route))
    phase("cm", lambda tid, route, part: CmdOp.commit(tid, route, part,
                                                      deas[tid], Deps.NONE))
    phase("ap", lambda tid, route, part: CmdOp.apply(tid, route, part,
                                                     deas[tid], Deps.NONE))
    check(int(plane.fallbacks) == 0,
          f"cmd batch: {int(plane.fallbacks)} ops fell back to the host")
    if hist_dev != hist_host:
        i = next(i for i, (a, b) in enumerate(zip(hist_host, hist_dev))
                 if a != b)
        raise SmokeFailure(f"cmd batch: decision histories diverge at op "
                           f"{i}: host {hist_host[i]} card {hist_dev[i]}")
    for tid, row in plane.row_of.items():
        check(int(plane.status_h[row]) == CMD_ST_APPLIED,
              f"cmd batch: {tid} did not reach APPLIED in the arena")
        check(cp._dec(*(int(x) for x in plane.ea_h[row]))
              == host_final[tid],
              f"cmd batch: final executeAt differs for {tid}")
    dev_committed_s = span_s["pa"] + span_s["cm"]
    return {"inflight": n, "chunk": chunk, "arena_cap": arena_cap,
            "dispatches": int(plane.dispatches),
            "fallbacks": int(plane.fallbacks),
            "checksum_mismatches": int(plane.checksum_mismatches),
            "handlers_committed_txn_per_s": n / host_committed_s,
            "device_committed_txn_per_s": n / dev_committed_s,
            "device_phase_s": span_s}


def recovery_batch(device: str, n: int) -> dict:
    """bench_recovery_storm's scan leg: n rows parked in one arena-only
    plane on `device` through real PreAccept/Commit/Apply dispatches (the
    last third driven to APPLIED: the scan must skip them), stall ages
    from default_rng(29), stall 1000 ms; one warm sweep, then every scan
    at now0 + 0/20/40/60 equal to recovery_scan_host and to a python walk,
    one dispatch per scan, zero fallbacks and overflows."""
    import numpy as np
    from accord_tpu_torch.ops.cmd_plane import CmdOp, CmdPlane
    from accord_tpu_torch.ops.kernels import (CMD_ST_APPLIED,
                                              CMD_ST_PRE_ACCEPTED)
    from accord_tpu_torch.primitives.deps import Deps
    chunk, arena_cap, stall_ms, ks = 512, 16_384, 1_000, (0, 20, 40, 60)
    _c, node, store = _one_store()
    txns = _cmd_stream(node, store, n, 7)
    plane = CmdPlane(store, initial_cap=arena_cap, key_cap=1024, kpad=4,
                     apply_to_store=False, device=device)
    eas = {}
    for i in range(0, n, chunk):
        span = txns[i:i + chunk]
        res = plane.eval_batch([CmdOp.preaccept(t, p, r)
                                for t, r, p in span])
        for (tid, *_), r in zip(span, res):
            eas[tid] = r.execute_at
    tail = txns[n - n // 3:]
    for i in range(0, len(tail), chunk):
        span = tail[i:i + chunk]
        plane.eval_batch([CmdOp.commit(t, r, p, eas[t], Deps.NONE)
                          for t, r, p in span])
        plane.eval_batch([CmdOp.apply(t, r, p, eas[t], Deps.NONE)
                          for t, r, p in span])
    arng = np.random.default_rng(29)
    now0 = int(node.now_millis()) + 100_000
    plane.touched_h[:plane.n_rows] = \
        now0 - arng.integers(0, 1_100, plane.n_rows, dtype=np.int32)
    plane._touched_stale = True

    def py_walk(now):
        out = []
        for tid, row in plane.row_of.items():
            st = int(plane.status_h[row])
            if CMD_ST_PRE_ACCEPTED <= st < CMD_ST_APPLIED \
                    and now - int(plane.touched_h[row]) >= stall_ms:
                out.append(tid)
        return out

    for k in ks:
        plane.recovery_scan_device(now0 + k, stall_ms)
    warm = {"fallbacks": int(plane.recovery_scan_fallbacks),
            "overflows": int(plane.recovery_scan_overflows)}
    d0 = int(plane.recovery_scan_dispatches)
    sizes, wall = [], {"device": 0.0, "host": 0.0, "walk": 0.0}
    for k in ks:
        t0 = time.perf_counter()
        dev = plane.recovery_scan_device(now0 + k, stall_ms)
        t1 = time.perf_counter()
        host = plane.recovery_scan_host(now0 + k, stall_ms)
        t2 = time.perf_counter()
        walk = py_walk(now0 + k)
        t3 = time.perf_counter()
        wall["device"] += t1 - t0
        wall["host"] += t2 - t1
        wall["walk"] += t3 - t2
        check(dev == host == walk,
              f"recovery batch: scan at now0+{k} differs from the host's")
        sizes.append(len(dev))
    check(int(plane.recovery_scan_dispatches) - d0 == len(ks),
          "recovery batch: not one dispatch per scan")
    check(int(plane.recovery_scan_fallbacks) == 0
          and int(plane.recovery_scan_overflows) == 0,
          "recovery batch: scan fallbacks or overflows")
    check(min(sizes) > 0, "recovery batch: vacuous (no candidates)")
    live = int(((plane.status_h >= CMD_ST_PRE_ACCEPTED)
                & (plane.status_h < CMD_ST_APPLIED)).sum())
    return {"rows": int(plane.n_rows), "live": live, "candidates": sizes,
            "warm_sweep": warm,
            "ms_per_scan": {k: v * 1e3 / len(ks) for k, v in wall.items()},
            "scan_dispatches": int(plane.recovery_scan_dispatches)}


def exec_counters(rep) -> dict:
    """Every exec plane and coordinator counter of a burn, summed over
    planes and coordinators (the wall-clock harvest stall left out)."""
    return {k: v for k, v in rep.counters.items()
            if k.startswith(("exec.", "exec_coord."))
            and not k.endswith("harvest_stall_s")}


def frontier_batch(device: str, rehearse: bool, recs, seed: int = 31) -> dict:
    """The frontier kernels at their largest. (a) bench.py's compacted
    harvest at 10k in flight: 5 planes x 2048 rows, every row pending, rows
    0/1 gate each other, every other row but 40 per plane waits on row 0
    (undecided executeAt); the compacted and the fused frontier must
    release exactly the 40. (b) one 16384-row plane: ~10,000 pending rows
    each waiting on up to 8 earlier rows (the wait sets of 4-key txns at
    10k in flight over 1k keys), signed exec_ts with ~10% undecided, ~5%
    awaits_all, half of the other rows applied; 64 dirty rows re-shipped
    through exec_scatter, then execution_frontier and frontier_compact,
    each equal to its plain version. recs: the Recorders of (a) and (b)."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops.tiers import OutCapTiers

    rng = np.random.default_rng(seed)
    neg = np.iinfo(np.int32).min
    up = (lambda a: tk.upload(np.ascontiguousarray(a), device))
    ecap, nplanes, per_plane = (256 if rehearse else 2048), 5, 40
    words = ecap // 32
    planes, expected = [], []
    for _ in range(nplanes):
        rel = np.sort(rng.choice(np.arange(2, ecap), per_plane,
                                 replace=False))
        adj = np.zeros((ecap, words), np.uint32)
        adj[0, 0] |= np.uint32(1 << 1)
        adj[1, 0] |= np.uint32(1)
        gated = np.ones(ecap, bool)
        gated[rel] = False
        gated[:2] = False
        adj[gated, 0] |= np.uint32(1)
        planes.append((up(adj.view(np.int32)),
                       up(np.full((ecap, 3), neg, np.int32)),
                       up(np.zeros(ecap, bool)), up(np.ones(ecap, bool)),
                       up(np.zeros(ecap, bool))))
        expected.append(rel.tolist())
    tiers = OutCapTiers(tk.FRONTIER_OUT_TIERS, tk.FRONTIER_OUT_TIERS[-1] * 2)
    out_cap = tiers.pick(nplanes * per_plane)
    with recs[0]:
        res = tk.frontier_compact(tuple(planes), out_cap=out_cap)
        fused = tk.fused_execution_frontier(tuple(planes)).cpu().numpy()
    indptr, rows, csum, _ = (t.cpu().numpy() for t in res)
    check(int(indptr[-1]) == nplanes * per_plane,
          f"frontier batch (a): bound {int(indptr[-1])} != "
          f"{nplanes * per_plane}")
    check(tk.frontier_checksum_host(indptr, rows) == int(csum) & 0xFFFFFFFF,
          "frontier batch (a): checksum mismatch")
    for s, exp in enumerate(expected):
        seg = rows[indptr[s]:indptr[s + 1]] - 32 * s * words
        check(seg.tolist() == exp,
              f"frontier batch (a): plane {s} compacted release set wrong")
        bits = np.unpackbits(fused[s * words:(s + 1) * words].view(np.uint8),
                             bitorder="little")
        check(np.nonzero(bits)[0].tolist() == exp,
              f"frontier batch (a): plane {s} fused release set wrong")

    cap = 1024 if rehearse else 16384
    npend = 600 if rehearse else 10_000
    pending = np.zeros(cap, bool)
    pending[rng.choice(cap, npend, replace=False)] = True
    adj = np.zeros((cap, cap // 32), np.uint32)
    w = np.repeat(np.nonzero(pending)[0], 8)
    k = rng.integers(0, 9, npend).repeat(8)     # 0-8 deps per waiter
    w = w[(np.tile(np.arange(8), npend) < k) & (w > 0)]
    d = (rng.random(w.size) * w).astype(np.int64)
    np.bitwise_or.at(adj, (w, d >> 5), np.uint32(1) << (d & 31)
                     .astype(np.uint32))
    ts = np.empty((cap, 3), np.int32)
    ts[:, 0] = rng.integers(-(1 << 20), 1 << 20, cap)
    ts[:, 1:] = rng.integers(neg, np.iinfo(np.int32).max, (cap, 2),
                             dtype=np.int64)
    ts[rng.random(cap) < 0.1] = neg
    applied = ~pending & (rng.random(cap) < 0.5)
    awaits = rng.random(cap) < 0.05
    base = (up(adj.view(np.int32)), up(ts), up(applied), up(pending),
            up(awaits))
    dirty = np.sort(rng.choice(np.nonzero(pending)[0], 64,
                               replace=False)).astype(np.int32)
    uploads = (up(dirty), up(adj[dirty].view(np.int32)), up(ts[dirty]),
               up(applied[dirty]), up(pending[dirty]), up(awaits[dirty]))
    with recs[1]:
        lanes = tk.exec_scatter(*base, *uploads)
        out = tk.execution_frontier(*lanes)
        res = tk.frontier_compact((lanes,), out_cap=tiers.pick(npend))
    check(max_abs_err(lanes, tk.exec_scatter_plain(*base, *uploads)) == 0,
          "frontier batch (b): exec_scatter != its plain version")
    plain = tk.execution_frontier_plain(*lanes)
    check(torch.equal(out, plain),
          "frontier batch (b): execution_frontier != its plain version")
    released = int(tk._popcount_u32(out).sum())
    ref = tk.frontier_compact_plain((lanes,), out_cap=tiers.pick(npend))
    check(max_abs_err(res, ref) == 0,
          "frontier batch (b): frontier_compact != its plain version")
    check(int(res[0][-1]) == released and released > 0,
          f"frontier batch (b): bound {int(res[0][-1])} vs {released} "
          "released")
    return {"a": {"planes": nplanes, "cap": ecap, "released": per_plane,
                  "out_cap": out_cap},
            "b": {"cap": cap, "pending": npend, "edges": int(w.size),
                  "released": released}}


COUNTERS = ("host_fallbacks", "range_fallbacks", "finalize_fallbacks",
            "legacy_decodes", "checksum_mismatches", "dispatches",
            "subjects", "finalized_decodes", "range_subject_device_decodes")


def clean(resolvers) -> dict:
    return {k: sum(int(getattr(r, k)) for r in resolvers) for k in COUNTERS}


def preaccept_batch(device: str, active: int, subjects_n: int,
                    ranges: int = 0, range_share: float = 0.0) -> dict:
    """bench.py's "Synthetic PreAccept batch" on the port: 10k in-flight
    writes over 1k keys (4 each) in one store, 4,096 fresh subjects through
    the async pipeline, each answer checked against the host scan. With
    `ranges`, that many in-flight range writes of 1-2 pieces (widths
    1-2048 over the 2^16 key domain, the burn's max_range_width) join the
    arena, and `range_share` of the subjects are range subjects of the
    same shape."""
    import torch
    from accord_tpu_torch.local.cfk import CfkStatus
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.primitives.keyspace import Keys, Range, Ranges
    from accord_tpu_torch.primitives.timestamp import Domain, TxnId, TxnKind
    from accord_tpu_torch.sim.cluster import Cluster, ClusterConfig
    from accord_tpu_torch.utils.rng import RandomSource

    resolver = BatchDepsResolver(num_buckets=1024, initial_cap=16384,
                                 max_dispatch=1024, device=device)
    cluster = Cluster(3, ClusterConfig(
        num_nodes=1, rf=1, stores_per_node=1, num_shards=1, progress=False,
        deps_resolver_factory=lambda: resolver, deps_batch_window_ms=None))
    node = cluster.nodes[1]
    store = node.command_stores.all()[0]
    rng = RandomSource(17)
    for _ in range(active):
        ts = node.unique_now()
        tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                           Domain.KEY)
        store.register(tid, Keys(rng.next_int(1000) for _ in range(4)),
                       CfkStatus.WITNESSED, ts)

    def pieces():
        out = []
        for _ in range(1 + rng.next_int(2)):
            s = rng.next_int((1 << 16) - 2048)
            out.append(Range(s, s + 1 + rng.next_int(2048)))
        return Ranges(out)

    for _ in range(ranges):
        ts = node.unique_now()
        tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                           Domain.RANGE)
        store.register(tid, pieces(), CfkStatus.WITNESSED, ts)
    subjects = []
    for i in range(subjects_n):
        ts = node.unique_now()
        if range_share and i % round(1 / range_share) == 0:
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                               Domain.RANGE)
            owned = store.owned(pieces())
        else:
            tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                               Domain.KEY)
            owned = store.owned(Keys(rng.next_int(1000) for _ in range(4)))
        subjects.append((tid, owned, ts))
    store.batch_window_ms = 2.0
    node.device_latency_ms = 80.0
    node.device_poll_ms = 1.0
    outs = []
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tid, keys, before in subjects:
        outs.append(resolver.enqueue_deps(store, tid, keys, before))
    cluster.queue.drain(max_events=1_000_000)
    wall = time.perf_counter() - t0
    check(all(o.done and o.failure is None for o in outs),
          "PreAccept batch: a resolution failed or never completed")
    bad = sum(1 for (tid, keys, before), o in zip(subjects, outs)
              if o.value() != store.host_calculate_deps(tid, keys, before))
    check(bad == 0, f"PreAccept batch: {bad}/{subjects_n} subjects differ "
          "from the host scan")
    deps = sum(len(o.value().key_deps.all_txn_ids()) for o in outs)
    rdeps = sum(len(o.value().range_deps.all_txn_ids()) for o in outs)
    check(deps > 0, "PreAccept batch: vacuous (no deps at all)")
    check(not ranges or rdeps > 0,
          "PreAccept batch: vacuous (no range deps at all)")
    return {"subjects": subjects_n, "active": active,
            "active_ranges": ranges, "range_share": range_share,
            "wall_s": wall,
            "subjects_per_s": subjects_n / wall,
            "device_block_us_per_subject":
                (resolver.harvest_stall_s + resolver.decode_s)
                / subjects_n * 1e6,
            "dispatches": int(resolver.dispatches),
            "mean_deps_per_subject": deps / subjects_n,
            "mean_range_deps_per_subject": rdeps / subjects_n,
            **{k: v for k, v in clean([resolver]).items()
               if k.endswith("fallbacks") or k in (
                   "checksum_mismatches", "legacy_decodes",
                   "range_subject_device_decodes")}}


def run(rehearse: bool) -> dict:
    import torch
    cuda = torch.cuda.is_available() and not rehearse
    device = "cuda" if cuda else "cpu"
    from accord_tpu_torch.ops import kernels as tk

    card = card_line(cuda)
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    if cuda:
        log(f"device: {torch.cuda.get_device_name(0)} x "
            f"{torch.cuda.device_count()}")
        build_s = build_phase()
        log(f"build: {build_s:.2f} s (all csrc/*.cu, nvcc in parallel)")

    ops = 800 if not rehearse else 120
    launches = {}
    # 3. key burn: the PR-1 path, launches counted
    key_rec = Recorder(tk)
    dev_res = []
    tk.reset_launches()
    with key_rec:
        rep, wall = burn(device, ops, dev_res)
    if cuda:
        torch.cuda.synchronize()
    launches["key_burn"] = dict(tk.LAUNCHES)
    log(f"burn[{device}]: acked {rep.acked} failed {rep.failed} lost "
        f"{rep.lost} in {wall:.2f} s -> {rep.acked / wall:.1f} acked txn/s; "
        f"launches {launches['key_burn']}; {clean(dev_res)}")
    check(rep.lost == 0 and rep.acked > 0, "burn: lost or no acked txns")
    stats = clean(dev_res)
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(stats[k] == 0, f"burn: {k} = {stats[k]}")
    if cuda:
        for name in ("deps_resolve", "finalize_csr", "arena_scatter",
                     "row_scatter"):
            check(launches["key_burn"][name] > 0,
                  f"burn: kernel {name} never launched")
    cpu_res = []
    rep_cpu, wall_cpu = burn("cpu", ops, cpu_res)
    log(f"burn[cpu]: acked {rep_cpu.acked} in {wall_cpu:.2f} s; "
        f"{clean(cpu_res)}")
    check(rep_cpu.log == rep.log,
          "burn: the card's history differs from the CPU's")
    log(f"burn: {len(rep.log)} log lines identical on {device} and cpu")

    # 4. range-mix burn: this slice's path, launches counted
    range_ops = 400 if not rehearse else 60
    range_rec = Recorder(tk)
    rdev = []
    tk.reset_launches()
    with range_rec:
        rrep, rwall = range_mix_burn(device, range_ops, rdev)
    if cuda:
        torch.cuda.synchronize()
    launches["range_burn"] = dict(tk.LAUNCHES)
    rstats = clean(rdev)
    log(f"range_burn[{device}]: acked {rrep.acked} failed {rrep.failed} "
        f"lost {rrep.lost} in {rwall:.2f} s -> {rrep.acked / rwall:.1f} "
        f"acked txn/s; launches {launches['range_burn']}; {rstats}")
    check(rrep.lost == 0 and rrep.acked > 0,
          "range burn: lost or no acked txns")
    for k in ("host_fallbacks", "range_fallbacks", "checksum_mismatches"):
        check(rstats[k] == 0, f"range burn: {k} = {rstats[k]}")
    check(rstats["range_subject_device_decodes"] > 0,
          "range burn: no range subject decoded on the device")
    if cuda:
        for name in ("range_scatter", "range_resolve", "range_finalize"):
            check(launches["range_burn"][name] > 0,
                  f"range burn: kernel {name} never launched")
    rcpu = []
    rrep_cpu, rwall_cpu = range_mix_burn("cpu", range_ops, rcpu)
    log(f"range_burn[cpu]: acked {rrep_cpu.acked} in {rwall_cpu:.2f} s; "
        f"{clean(rcpu)}")
    check(rrep_cpu.log == rrep.log,
          "range burn: the card's history differs from the CPU's")
    check(clean(rcpu) == rstats,
          f"range burn: the card's resolver counters {rstats} differ from "
          f"the CPU's {clean(rcpu)}")
    log(f"range_burn: {len(rrep.log)} log lines identical on {device} and "
        "cpu")

    # 5. inline leg: max_conflict on the device, launches counted
    inline_rec = Recorder(tk)
    ires = []
    tk.reset_launches()
    with inline_rec:
        irep, iwall = inline_burn(device, ires)
    if cuda:
        torch.cuda.synchronize()
    launches["inline"] = dict(tk.LAUNCHES)
    log(f"inline[{device}]: acked {irep.acked} lost {irep.lost} in "
        f"{iwall:.2f} s; launches {launches['inline']}; {clean(ires)}")
    check(irep.lost == 0 and irep.acked == 80, "inline: lost or not acked")
    check(clean(ires)["host_fallbacks"] == 0, "inline: host fallbacks")
    if cuda:
        check(launches["inline"]["max_conflict"] > 0,
              "inline: kernel max_conflict never launched")
    irep_cpu, _ = inline_burn("cpu", [])
    check(irep_cpu.log == irep.log,
          "inline: the card's history differs from the CPU's")
    log(f"inline: {len(irep.log)} log lines identical on {device} and cpu")

    # 6. the PreAccept batches (their own kernel inputs recorded too)
    pa_rec = Recorder(tk)
    with pa_rec:
        pa = preaccept_batch(device, 10_000 if not rehearse else 1_000,
                             4_096 if not rehearse else 256)
    log(f"preaccept_batch[{device}]: {json.dumps(pa)}")
    pr_rec = Recorder(tk)
    with pr_rec:
        par = preaccept_batch(device, 10_000 if not rehearse else 1_000,
                              4_096 if not rehearse else 256,
                              ranges=1_024 if not rehearse else 128,
                              range_share=0.2)
    log(f"preaccept_batch_ranges[{device}]: {json.dumps(par)}")
    for batch in (pa, par):
        for k in ("host_fallbacks", "range_fallbacks", "finalize_fallbacks",
                  "checksum_mismatches"):
            check(batch[k] == 0, f"PreAccept batch: {k} = {batch[k]}")
    check(par["range_subject_device_decodes"] > 0,
          "PreAccept batch: no range subject decoded on the device")

    # 7-9. the exec plane: fused, compacted (+ resolver), solo
    exec_ops = 400 if not rehearse else 60
    exec_recs = {}
    for path, ops_, kw in (
            ("exec_burn", exec_ops, {}),
            ("exec_compact", exec_ops, {"compact": True}),
            ("exec_solo", 120 if not rehearse else 40, {"stores": 1})):
        rec = exec_recs[path] = Recorder(tk)
        with_res = path == "exec_compact"
        eres = [] if with_res else None
        tk.reset_launches()
        with rec:
            erep, ewall = exec_burn(device, ops_, resolvers=eres, **kw)
        if cuda:
            torch.cuda.synchronize()
        launches[path] = dict(tk.LAUNCHES)
        ecnt = exec_counters(erep)
        log(f"{path}[{device}]: acked {erep.acked} failed {erep.failed} lost "
            f"{erep.lost} in {ewall:.2f} s -> {erep.acked / ewall:.1f} acked "
            f"txn/s; launches {launches[path]}; {json.dumps(ecnt)}"
            + (f"; resolver {clean(eres)}" if with_res else ""))
        check(erep.lost == 0 and erep.acked == ops_,
              f"{path}: lost or unacked txns")
        check(ecnt.get("exec.releases", 0) > 0, f"{path}: no releases")
        cres = [] if with_res else None
        crep, cwall = exec_burn("cpu", ops_, resolvers=cres, **kw)
        log(f"{path}[cpu]: acked {crep.acked} in {cwall:.2f} s")
        check(crep.log == erep.log,
              f"{path}: the card's history differs from the CPU's")
        check(exec_counters(crep) == ecnt,
              f"{path}: the card's exec counters {ecnt} differ from the "
              f"CPU's {exec_counters(crep)}")
        if with_res:
            check(clean(cres) == clean(eres),
                  f"{path}: the card's resolver counters differ from the "
                  "CPU's")
            for k in ("host_fallbacks", "checksum_mismatches"):
                check(clean(eres)[k] == 0, f"{path}: {k} = {clean(eres)[k]}")
            check(ecnt.get("exec_coord.compact_fallbacks", 0) == 0,
                  f"{path}: compact fallbacks")
        log(f"{path}: {len(erep.log)} log lines identical on {device} and "
            "cpu")
        if path == "exec_burn":
            ts_flags = (ecnt.get("exec.upload_bytes.ts", 0)
                        + ecnt.get("exec.upload_bytes.flags", 0))
            check(ts_flags > 0, "exec burn: no granular ts/flags uploads")
            check(ecnt["exec.upload_bytes"]
                  < ecnt["exec.upload_bytes_full_equiv"],
                  "exec burn: granular uploads not below the whole-row "
                  "baseline")
            check(ecnt.get("exec_coord.fused_dispatches", 0) > 0,
                  "exec burn: no fused dispatch")
        if cuda:
            must = {"exec_scatter", *(n for n in EXEC_KERNELS
                                      if PATH_OF[n] == path)}
            if with_res:
                must |= {"deps_resolve", "finalize_csr"}
            for name in sorted(must):
                check(launches[path][name] > 0,
                      f"{path}: kernel {name} never launched")

    # 10. the frontier kernels at their largest
    fa_rec, fb_rec = Recorder(tk), Recorder(tk)
    fb = frontier_batch(device, rehearse, (fa_rec, fb_rec))
    log(f"frontier_batch[{device}]: {json.dumps(fb)}")

    # 11. cmd burn: the key burn's cluster with the command planes on the
    #     card too, launches counted
    cmd_ops = 400 if not rehearse else 60
    cmd_rec = Recorder(tk, cmd_tier=8)
    cdev = []
    tk.reset_launches()
    with cmd_rec:
        crep, cwall = burn(device, cmd_ops, cdev, cmd_plane=True,
                           cmd_device=device)
    if cuda:
        torch.cuda.synchronize()
    launches["cmd_burn"] = dict(tk.LAUNCHES)
    ccnt = cmd_counters(crep)
    log(f"cmd_burn[{device}]: acked {crep.acked} failed {crep.failed} lost "
        f"{crep.lost} in {cwall:.2f} s -> {crep.acked / cwall:.1f} acked "
        f"txn/s; launches {launches['cmd_burn']}; {json.dumps(ccnt)}; "
        f"resolver {clean(cdev)}")
    check(crep.lost == 0 and crep.acked > 0, "cmd burn: lost or no acked")
    check(ccnt.get("cmd_plane_dispatches", 0) > 0, "cmd burn: no dispatch")
    check(ccnt.get("cmd_plane_checksum_mismatches", 0) == 0,
          "cmd burn: checksum mismatches")
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(clean(cdev)[k] == 0, f"cmd burn: resolver {k}")
    if cuda:
        check(launches["cmd_burn"]["cmd_tick"]
              == ccnt["cmd_plane_dispatches"],
              f"cmd burn: cmd_tick launched "
              f"{launches['cmd_burn']['cmd_tick']} times for "
              f"{ccnt['cmd_plane_dispatches']} dispatches")
        for name in ("deps_resolve", "finalize_csr", "row_scatter"):
            check(launches["cmd_burn"][name] > 0,
                  f"cmd burn: kernel {name} never launched")
    ccpu = []
    crep_cpu, cwall_cpu = burn("cpu", cmd_ops, ccpu, cmd_plane=True,
                               cmd_device="cpu")
    log(f"cmd_burn[cpu]: acked {crep_cpu.acked} in {cwall_cpu:.2f} s")
    check(crep_cpu.log == crep.log,
          "cmd burn: the card's history differs from the CPU's")
    check(cmd_counters(crep_cpu) == ccnt,
          f"cmd burn: the card's cmd counters {ccnt} differ from the CPU's "
          f"{cmd_counters(crep_cpu)}")
    check(clean(ccpu) == clean(cdev),
          "cmd burn: the card's resolver counters differ from the CPU's")
    log(f"cmd_burn: {len(crep.log)} log lines identical on {device} and cpu")

    # 12. authoritative + recovery leg, launches counted
    rec_rec = Recorder(tk)
    tk.reset_launches()
    with rec_rec:
        rrep_d, rwall_d = recovery_burn(device, "device")
    if cuda:
        torch.cuda.synchronize()
    launches["recovery_burn"] = dict(tk.LAUNCHES)
    rcnt = cmd_counters(rrep_d)
    log(f"recovery_burn[{device}]: acked {rrep_d.acked} lost {rrep_d.lost} "
        f"in {rwall_d:.2f} s; launches {launches['recovery_burn']}; "
        f"promote calls {rec_rec.promoted}; {json.dumps(rcnt)}")
    check(rrep_d.lost == 0 and rrep_d.acked == 48,
          "recovery burn: lost or unacked txns")
    check(rcnt.get("recovery_scan_candidates", 0) > 0,
          "recovery burn: the scan found no candidate")
    # an out_cap overflow is answered by the host scan (the reference's
    # degradation, counted); held at 0 so every scan here is the kernel's
    log(f"recovery_burn[{device}]: scan fallbacks "
        f"{rcnt.get('recovery_scan_fallbacks', 0)} overflows "
        f"{rcnt.get('recovery_scan_overflows', 0)} checksum mismatches "
        f"{rcnt.get('cmd_plane_checksum_mismatches', 0)}")
    check(rcnt.get("recovery_scan_fallbacks", 0) == 0,
          "recovery burn: scan fallbacks")
    check(rcnt.get("recovery_scan_overflows", 0) == 0,
          "recovery burn: scan overflows answered by the host scan")
    check(rcnt.get("cmd_plane_checksum_mismatches", 0) == 0,
          "recovery burn: checksum mismatches")
    check(rec_rec.promoted > 0
          and rec_rec.promoted == rcnt["cmd_plane_dispatches"],
          "recovery burn: cmd_tick did not run with promote")
    if cuda:
        check(launches["recovery_burn"]["recovery_scan"]
              == rcnt["recovery_scan_dispatches"] > 0,
              "recovery burn: recovery_scan launches != scan dispatches")
        check(launches["recovery_burn"]["cmd_tick"]
              == rcnt["cmd_plane_dispatches"] > 0,
              "recovery burn: cmd_tick launches != dispatches")
    rrep_c, rwall_c = recovery_burn("cpu", "device")
    rrep_h, rwall_h = recovery_burn(device, "host")
    log(f"recovery_burn[cpu]: {rwall_c:.2f} s; host scan on {device}: "
        f"{rwall_h:.2f} s")
    check(rrep_c.log == rrep_d.log,
          "recovery burn: the card's history differs from the CPU's")
    check(rrep_h.log == rrep_d.log,
          "recovery burn: the device scan's history differs from the host "
          "scan's")
    check(cmd_counters(rrep_c) == rcnt,
          f"recovery burn: the card's counters {rcnt} differ from the "
          f"CPU's {cmd_counters(rrep_c)}")
    log(f"recovery_burn: {len(rrep_d.log)} log lines identical on {device}, "
        "cpu and with the host scan")

    # 13. repair leg, launches counted
    rep_rec = Recorder(tk)
    tk.reset_launches()
    with rep_rec:
        rleg = repair_leg(device)
    if cuda:
        torch.cuda.synchronize()
    launches["repair"] = dict(tk.LAUNCHES)
    log(f"repair[{device}]: {json.dumps(rleg)}; launches "
        f"{launches['repair']}")
    if cuda:
        check(launches["repair"]["cmd_repair"] > 0,
              "repair leg: cmd_repair never launched")

    # 14-15. the command plane at 10k in flight
    cb_rec = Recorder(tk)
    with cb_rec:
        cb = cmd_batch(device, 10_000 if not rehearse else 600)
    log(f"cmd_batch[{device}]: {json.dumps(cb)}")
    rb_rec = Recorder(tk)
    with rb_rec:
        rb = recovery_batch(device, 10_240 if not rehearse else 600)
    log(f"recovery_batch[{device}]: {json.dumps(rb)}")

    # 16. kernels: replay the recorded inputs, kernel vs plain, timed
    iters = 50 if cuda else 2
    path_rec = {"key_burn": key_rec, "range_burn": range_rec,
                "inline": inline_rec, **exec_recs, "cmd_burn": cmd_rec,
                "recovery_burn": rec_rec, "repair": rep_rec}
    # further inputs each kernel is replayed on, by label (the first
    # two keep their PR-1/PR-2 names in the kernels line)
    extra_rec = {"key_burn": [("preaccept_batch", pa_rec),
                              ("range_burn", range_rec)],
                 "range_burn": [("preaccept_batch", pr_rec)],
                 "inline": [], "cmd_burn": [("cmd_batch", cb_rec)],
                 "recovery_burn": [("recovery_batch", rb_rec)],
                 "repair": []}
    exec_extra = [("exec_burn", exec_recs["exec_burn"]),
                  ("exec_compact", exec_recs["exec_compact"]),
                  ("frontier_batch_a", fa_rec),
                  ("frontier_batch_b", fb_rec)]
    entries = []
    for name, source, replaces in KERNELS:
        path = PATH_OF[name]
        log(f"kernel {name}, {path} inputs:")
        head = kernel_report(tk, name, path_rec[path], cuda, iters)
        reports = [head]
        if name in EXEC_KERNELS:
            extra = [(lab, r) for lab, r in exec_extra
                     if lab != path and r.get(name) is not None]
        else:
            extra = extra_rec[path]
        labelled = []
        for label, rec in extra:
            log(f"kernel {name}, {label} inputs:")
            labelled.append((label, kernel_report(tk, name, rec, cuda,
                                                  iters)))
            reports.append(labelled[-1][1])
        for k in reports:
            check(k["max_abs_err"] == 0,
                  f"kernel {name} disagrees with its plain version")
        entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[path][name],
            "path": path,
            "max_abs_err": max(k["max_abs_err"] for k in reports),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "call": head["call"],
            "calls": [_brief(r) for r in head["calls"]],
            **{k: head[k] for k in ("op_tier", "ms_per_op") if k in head},
            "launches_by_path": {p: launches[p][name] for p in launches}}
        for label, r in labelled:
            entry[label] = dict(_brief(r),
                                calls=[_brief(c) for c in r["calls"]])
        entries.append(entry)
    return {"card": card, "entries": entries, "cuda": cuda,
            "acked_per_s": rep.acked / wall}


def _brief(row: dict) -> dict:
    return {k: row[k] for k in ("call", "ms", "plain_ms", "bound_ms",
                                "bound_by", "share", "library_ms",
                                "op_tier", "ms_per_op") if k in row}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    rehearse = "--rehearse" in argv
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); the port's kernels run only on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import accord_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run "
              "from the repository root", file=sys.stderr)
        return 1
    try:
        res = run(rehearse)
    except Exception as e:  # noqa: BLE001 -- every phase failure fails
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    if rehearse:
        print("chip_smoke: rehearsal on the CPU finished; no result",
              file=sys.stderr)
        return 3
    log(res["card"])
    log(json.dumps({"kernels": res["entries"]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
