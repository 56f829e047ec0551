"""Time K9 (csrc/exec_frontier.cu: `exec_frontier`, its fused form and
`frontier_compact`, each ONE launch, the compaction in the frontier's
kernel) and K20 (csrc/dense_dag.cu: `execution_wavefronts`, ONE persistent
cooperative launch) beside their parents (`tools/frontier_wavefront_parent.cu`),
on the same card in the same process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its three entries keep the shipped C signatures, so `parent_kernels()`
binds them in place of the shipped libraries' in ops/_ext.py's entry cache
(deps_block_variants.bound): every K9 and K20 launch made inside, eager or
captured into a CUDA graph (the protocol megakernel's exec stage too),
runs the parent's kernels. The pair helpers are deps_block_variants' (A B
B A interleaved graph replays, three rounds, the median; every pair
bit-equal):

    call_pair(fn_name, args, kw)   a whole K9 or K20 wrapper call
    tick_pair(wt, kw)              a protocol_tick graph's replay (its exec
                                   outputs compared), with the kernels one
                                   replay runs on each side (a profiler
                                   trace: run it last in a process)

Run alone it times K9 at the frontier batches of chip_smoke.py (a: 5
planes x 2,048 rows, every row pending; b: one 16,384-row plane, ~10,000
pending) through all three entries, at the fused, compacted and solo exec
burns' largest calls, and the exec-in-megakernel leg's largest replay
with each K9; K20 at the graft entry (N 128, 7 levels) and at N 8,192
with 64 levels:

    python -m accord_tpu_torch.tools.frontier_wavefront_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import subprocess
import sys

from accord_tpu_torch.tools import deps_block_variants as dbv

ROOT = pathlib.Path(__file__).resolve().parents[2]
PARENT = pathlib.Path(__file__).resolve().parent / \
    "frontier_wavefront_parent.cu"
# the K9 and K20 wrappers the pairs time
K9_FNS = ("execution_frontier", "fused_execution_frontier",
          "frontier_compact")
_LIB: list = []


def _so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "frontier_wavefront_variants" / "parent.so"


def start_build():
    """Start nvcc on the parent's file (to overlap the shipped build);
    finish_build waits for it."""
    from accord_tpu_torch.ops import _ext
    so = _so()
    so.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen(
        [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o", str(so),
         str(PARENT)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def finish_build(proc) -> ctypes.CDLL:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {PARENT.name}:\n{log}")
    _LIB[:] = [ctypes.CDLL(str(_so()))]
    return _LIB[0]


def _entries() -> dict:
    from accord_tpu_torch.ops import kernels
    return {("exec_frontier", "exec_frontier"): kernels._FRONTIER_ARGS,
            ("exec_frontier", "frontier_compact"):
                kernels._FRONTIER_COMPACT_ARGS,
            ("dense_dag", "execution_wavefronts"): kernels._WAVE_ARGS}


@contextlib.contextmanager
def parent_kernels():
    """Inside, K9's two C entries and K20's resolve to the parent's
    library."""
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with dbv.bound(lib, _entries(), "parent K9/K20"):
        yield


def call_pair(fn_name: str, args, kw=None) -> dict:
    """The shipped and the parent's kernel on one call of kernels.fn_name
    (a K9 entry or execution_wavefronts): bit-equal, device ms of each."""
    from accord_tpu_torch.ops import kernels as tk
    fn = getattr(tk, fn_name)
    return dbv.call_pair(lambda: fn(*args, **(kw or {})),
                         parent=parent_kernels)


def _replay_kernels(replay) -> int:
    """The kernels a torch.profiler trace shows in one call of replay."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "memset" not in e.name.lower()
               and "memcpy" not in e.name.lower())


def tick_pair(wt, kw, count: bool = True) -> dict:
    """The protocol_tick graph of `kw` (with an exec stage) replayed with
    each K9: its exec outputs bit-equal, each side's replay ms and (with
    `count`) the kernels one replay runs, from a torch.profiler trace of
    each side's replay -- after which this process's profiler may deliver
    no more kernel events, so chip_smoke.py, which traces later, passes
    count=False."""
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops import tick_graph
    counts = {}
    if count:
        with parent_kernels():
            tk.protocol_tick(wt, **kw)
            p_graph = next(reversed(tick_graph._GRAPHS.values())).graph
            counts["parent_kernels"] = _replay_kernels(p_graph.replay)
    pair = dbv.replay_pair(lambda: tk.protocol_tick(wt, **kw),
                           lambda o: o[-1], parent=parent_kernels)
    if count:
        graph = next(reversed(tick_graph._GRAPHS.values())).graph
        counts["new_kernels"] = _replay_kernels(graph.replay)
    return dict(pair, **counts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("frontier_wavefront_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch import graft_entry
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    proc = start_build()
    _ext.build()
    finish_build(proc)
    dev = "cuda"
    res = {"k9": {}, "k20": {}}
    recs = (smoke.Recorder(tk), smoke.Recorder(tk))
    smoke.frontier_batch(dev, False, recs)
    burns = {"exec_burn": (400, {}), "exec_compact": (400, {"compact": True}),
             "exec_solo": (120, {"stores": 1})}
    for label, (ops, bkw) in burns.items():
        rec = smoke.Recorder(tk)
        with rec:
            smoke.exec_burn(dev, ops, **bkw)
        recs += (rec,)
    labels = ("frontier_batch_a", "frontier_batch_b", *burns)
    for label, rec in zip(labels, recs):
        for fn_name in K9_FNS:
            got = rec.get(fn_name)
            if got is not None:
                res["k9"][f"{label}:{fn_name}"] = call_pair(fn_name, *got)
    tick = smoke.Recorder(tk, names=("protocol_tick",),
                          keep=lambda _n, _a, kw: bool(kw.get("execs")))
    with tick:
        smoke.mesh_leg(dev, 13, 40, "mega", **smoke.MEGA_EXEC)
    args, kw = tick.get("protocol_tick")
    res["k9"]["mega_exec_replay"] = tick_pair(args[0], kw)
    step, gargs = graft_entry.entry(dev)
    rec = smoke.Recorder(tk, names=("execution_wavefronts",))
    with rec:
        step(*gargs)
    res["k20"]["graft_entry"] = call_pair("execution_wavefronts",
                                          *rec.get("execution_wavefronts"))
    mid = smoke.dense_batch_args(dev, False)[1]
    res["k20"]["n8192_64"] = call_pair("execution_wavefronts", (mid, 64))
    ok = all(r["bit_equal"] for part in res.values() for r in part.values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
