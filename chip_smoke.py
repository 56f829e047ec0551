#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (accord_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py              # on a machine with a CUDA card
    python3 chip_smoke.py --rehearse   # the same phases on the CPU, small
                                       # (exercises the script; no result)

Phases, each of which fails the run (exit 1, no result line) on any error:
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build every CUDA kernel from accord_tpu_torch/csrc (nvcc, in parallel);
  3. burn, the main path: a 5-node cluster commits rw-register txns
     (4 keys, Zipf 0.99 over 16 hot keys) through the port's
     BatchDepsResolver on the card; every kernel's launch count is zeroed
     just before and read just after, and each kernel must have launched;
     then the same seed with the resolver on the CPU must commit the
     identical history, with zero host, finalize and checksum fallbacks;
  4. the PreAccept batch: 10,000 in-flight writes over 1,000 keys, 4,096
     subjects through the async pipeline, every answer equal to the host
     scan;
  5. kernels: each kernel's wrapper is called again on the card on the
     exact inputs the burn (and the PreAccept batch) gave it, and held
     bit-equal against its plain PyTorch version on the same inputs;
     kernel, plain and (where one exists) single-library-call times come
     from CUDA events, and each kernel's bound from the bytes it must move
     (3.35 TB/s) or the operations it must do.
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
)
# kernel-module functions recorded during the burn, by kernel
RECORDED = {"deps_resolve": ("deps_resolve", "fused_deps_resolve"),
            "finalize_csr": ("finalize_csr",),
            "arena_scatter": ("arena_scatter", "arena_scatter_keys"),
            "row_scatter": ("scatter_rows", "kid_word_scatter",
                            "arena_grow")}


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
    each kernel. Recording launches nothing itself."""

    def __init__(self, tk):
        self.tk = tk
        self.calls = {}
        self.orig = {}

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
    the kernel's headline. arena_grow, which a burn whose arenas never
    outgrow their capacity does not call, replays on the arena lanes the
    recorded arena_scatter call was given, doubled."""
    plain_of = {
        "deps_resolve": tk.deps_resolve_plain,
        "fused_deps_resolve": tk.fused_deps_resolve_plain,
        "finalize_csr": tk.finalize_csr_plain,
        "arena_scatter": tk.arena_scatter_plain,
        "arena_scatter_keys": tk.arena_scatter_keys_plain,
        "scatter_rows": tk._scatter_lane_plain,
        "kid_word_scatter": tk.kid_word_scatter_plain,
        "arena_grow": tk.arena_grow_plain,
    }
    calls = []
    for fn_name in RECORDED[name]:
        got = rec.get(fn_name)
        if got is None and fn_name == "arena_grow":
            lanes = rec.get("arena_scatter")
            if lanes is not None:
                arena = lanes[0][:5]
                got = (arena, {"new_cap": 2 * arena[0].shape[0]})
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
        row = {"call": fn_name, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": bytes_, "ops": ops,
               "library_ms": (time_ms(library, iters, cuda)
                              if library is not None else None),
               "input_mb": nbytes(args) / 1e6}
        log(f"  {json.dumps(row)}")
        rows.append(row)
    head = max(rows, key=lambda r: r["input_mb"])
    return dict(head, max_abs_err=max(r["max_abs_err"] for r in rows))


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
    _ext.build()
    for name in ("deps_resolve", "finalize_csr", "arena_scatter",
                 "row_scatter"):
        _ext.lib(name)
    for stem, text in sorted(_ext.ptxas_log.items()):
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = sum(int(m) for m in
                     re.findall(r"(\d+) bytes spill stores", text))
        log(f"  ptxas {stem}: {len(regs)} kernels, at most "
            f"{max(regs, default=0)} registers, {spills} bytes spilled")
    return time.perf_counter() - t0


def burn(device: str, ops: int, resolvers: list, seed: int = 9):
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
                        progress_stall_ms=5000.0)
    t0 = time.perf_counter()
    rep = run_burn(seed, ops=ops, key_count=16, zipf_theta=0.99,
                   max_keys_per_txn=4, concurrency=1024, write_ratio=0.7,
                   config=cfg, collect_log=True)
    return rep, time.perf_counter() - t0


def clean(resolvers) -> dict:
    keys = ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches",
            "dispatches", "subjects", "finalized_decodes", "legacy_decodes")
    return {k: sum(int(getattr(r, k)) for r in resolvers) for k in keys}


def preaccept_batch(device: str, active: int, subjects_n: int) -> dict:
    """bench.py's "Synthetic PreAccept batch" on the port: 10k in-flight
    writes over 1k keys (4 each) in one store, 4,096 fresh subjects through
    the async pipeline, each answer checked against the host scan."""
    import torch
    from accord_tpu_torch.local.cfk import CfkStatus
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.primitives.keyspace import Keys
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
    subjects = []
    for _ in range(subjects_n):
        ts = node.unique_now()
        tid = TxnId.create(ts.epoch, ts.hlc, ts.node, TxnKind.WRITE,
                           Domain.KEY)
        keys = store.owned(Keys(rng.next_int(1000) for _ in range(4)))
        subjects.append((tid, keys, ts))
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
    check(deps > 0, "PreAccept batch: vacuous (no deps at all)")
    return {"subjects": subjects_n, "active": active, "wall_s": wall,
            "subjects_per_s": subjects_n / wall,
            "device_block_us_per_subject":
                (resolver.harvest_stall_s + resolver.decode_s)
                / subjects_n * 1e6,
            "dispatches": int(resolver.dispatches),
            "mean_deps_per_subject": deps / subjects_n,
            **{k: v for k, v in clean([resolver]).items()
               if k.endswith("fallbacks") or k == "checksum_mismatches"}}


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
    # 3. the main path: the burn on the card, launches counted
    main_rec = Recorder(tk)
    dev_res = []
    tk.reset_launches()
    with main_rec:
        rep, wall = burn(device, ops, dev_res)
    if cuda:
        torch.cuda.synchronize()
    launches = dict(tk.LAUNCHES)
    log(f"burn[{device}]: acked {rep.acked} failed {rep.failed} lost "
        f"{rep.lost} in {wall:.2f} s -> {rep.acked / wall:.1f} acked txn/s; "
        f"launches {launches}; {clean(dev_res)}")
    check(rep.lost == 0 and rep.acked > 0, "burn: lost or no acked txns")
    stats = clean(dev_res)
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(stats[k] == 0, f"burn: {k} = {stats[k]}")
    if cuda:
        for name, *_ in KERNELS:
            check(launches[name] > 0, f"burn: kernel {name} never launched")
    cpu_res = []
    rep_cpu, wall_cpu = burn("cpu", ops, cpu_res)
    log(f"burn[cpu]: acked {rep_cpu.acked} in {wall_cpu:.2f} s; "
        f"{clean(cpu_res)}")
    check(rep_cpu.log == rep.log,
          "burn: the card's history differs from the CPU's")
    log(f"burn: {len(rep.log)} log lines identical on {device} and cpu")

    # 4. the PreAccept batch (its own kernel inputs recorded too)
    pa_rec = Recorder(tk)
    with pa_rec:
        pa = preaccept_batch(device, 10_000 if not rehearse else 1_000,
                             4_096 if not rehearse else 256)
    log(f"preaccept_batch[{device}]: {json.dumps(pa)}")
    for k in ("host_fallbacks", "finalize_fallbacks", "checksum_mismatches"):
        check(pa[k] == 0, f"PreAccept batch: {k} = {pa[k]}")

    # 5. kernels: replay the recorded inputs, kernel vs plain, timed
    iters = 50 if cuda else 2
    entries = []
    for name, source, replaces in KERNELS:
        log(f"kernel {name}, burn inputs:")
        burn_k = kernel_report(tk, name, main_rec, cuda, iters)
        log(f"kernel {name}, PreAccept-batch inputs:")
        base_k = kernel_report(tk, name, pa_rec, cuda, iters)
        for k in (burn_k, base_k):
            check(k["max_abs_err"] == 0,
                  f"kernel {name} disagrees with its plain version")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(burn_k["max_abs_err"], base_k["max_abs_err"]),
            "ms": burn_k["ms"], "plain_ms": burn_k["plain_ms"],
            "bound_ms": burn_k["bound_ms"], "bound_by": burn_k["bound_by"],
            "library_ms": burn_k["library_ms"], "call": burn_k["call"],
            "preaccept_batch": {k: base_k[k] for k in (
                "call", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    return {"card": card, "entries": entries, "cuda": cuda,
            "acked_per_s": rep.acked / wall}


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
