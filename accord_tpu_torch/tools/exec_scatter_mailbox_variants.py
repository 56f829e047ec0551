"""Time K8 (csrc/exec_scatter.cu: `exec_scatter`, ONE launch a call) and
K23 (csrc/mailbox_shard.cu: `mailbox_shard_route`, the scatter and the
gather-back in ONE launch) beside their parents
(`tools/exec_scatter_mailbox_parent.cu`), on the same card in the same
process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its entries keep the shipped C signatures, so `parent_kernels()` binds
them in place of the shipped libraries' in ops/_ext.py's entry cache
(deps_block_variants.bound): every K8 and K23 launch made inside, eager or
captured into a CUDA graph (the sharded megakernel's mailbox stage too),
runs the parent's kernels. The pair helpers (A B B A interleaved graph
replays, three rounds, the median; every pair bit-equal):

    k8_pair(args)             one exec_scatter call, CALLS calls a graph
    k23_pair(S, block)        one sharded_mailbox_route call on a mailbox
                              block, each side on its own copy of the
                              arena and meta, 100 calls a graph (as
                              chip_smoke.py's phase f times K23)
    tick_pair(args, kw)       a sharded_protocol_tick graph's replay (its
                              mailbox outputs compared), with the kernels
                              one replay runs on each side (a profiler
                              trace: run it last in a process)

Run alone it times K8 at the fused exec burn's largest call (cap 1,024)
and at chip_smoke.py's frontier batch b (cap 16,384, 64 rows), and K23 at
the sharded message plane's largest mailbox block (256 nodes x 30 ops on
the virtual 4 x 2 mesh), at the 1,024-lane tier (W 384) and in the largest
tick's replay:

    python -m accord_tpu_torch.tools.exec_scatter_mailbox_variants

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
    "exec_scatter_mailbox_parent.cu"
K23_CALLS = 100
_LIB: list = []


def _so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "exec_scatter_mailbox_variants" / "parent.so"


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
    from accord_tpu_torch.ops import kernels, mailbox
    return {("exec_scatter", "exec_scatter"): kernels._EXEC_SCATTER_ARGS,
            ("mailbox_shard", "mailbox_shard_route"):
                mailbox._SHARD_ROUTE_ARGS,
            ("mailbox_shard", "mailbox_shard_land"):
                mailbox._SHARD_LAND_ARGS}


@contextlib.contextmanager
def parent_kernels():
    """Inside, K8's C entry and K23's two resolve to the parent's
    library."""
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with dbv.bound(lib, _entries(), "parent K8/K23"):
        yield


def k8_pair(args) -> dict:
    """The shipped and the parent's K8 on one exec_scatter call (its
    outputs are fresh lanes: every call of a graph rewrites the same)."""
    from accord_tpu_torch.ops import kernels as tk
    return dbv.call_pair(lambda: tk.exec_scatter(*args),
                         parent=parent_kernels)


def k23_pair(S: int, block) -> dict:
    """The shipped and the parent's K23 on one mailbox block (card
    tensors: arena, meta, the seven emit lanes, part), each side routing
    in place into its own copy of the arena and meta (routing the same
    lanes again rewrites the same rows): outputs bit-equal, device ms a
    call from a graph of K23_CALLS calls."""
    import torch
    from accord_tpu_torch.ops import mailbox as mb
    arena, meta, *lanes, part = block
    mine = (arena.clone(), meta.clone())
    theirs = (arena.clone(), meta.clone())

    def call(am):
        return mb.sharded_mailbox_route(S, *am, *lanes, part)
    out = call(mine)
    with parent_kernels():
        p_out = call(theirs)
        p_graph = dbv._capture(lambda: call(theirs), K23_CALLS)
    torch.cuda.synchronize()
    equal = dbv._same(out, p_out)
    graph = dbv._capture(lambda: call(mine), K23_CALLS)
    t = dbv._interleaved({"new": (graph.replay, K23_CALLS),
                          "parent": (p_graph.replay, K23_CALLS)})
    return {"new_ms": t["new"]["ms"], "parent_ms": t["parent"]["ms"],
            "new_samples": t["new"]["samples"],
            "parent_samples": t["parent"]["samples"],
            "bit_equal": equal}


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


def tick_pair(args, kw, count: bool = True) -> dict:
    """The sharded_protocol_tick graph of (args, kw) (with a mailbox
    stage) replayed with each K23: its mailbox outputs bit-equal, each
    side's replay ms and (with `count`) the kernels one replay runs, from
    a torch.profiler trace of each side's replay -- after which this
    process's profiler may deliver no more kernel events, so chip_smoke.py,
    which traces later, passes count=False."""
    from accord_tpu_torch.ops import tick_graph
    from accord_tpu_torch.parallel import mesh as pm
    counts = {}
    if count:
        with parent_kernels():
            pm.sharded_protocol_tick(*args, **kw)
            p_graph = next(reversed(tick_graph._GRAPHS.values())).graph
            counts["parent_kernels"] = _replay_kernels(p_graph.replay)
    pair = dbv.replay_pair(lambda: pm.sharded_protocol_tick(*args, **kw),
                           lambda o: o[5], parent=parent_kernels)
    if count:
        graph = next(reversed(tick_graph._GRAPHS.values())).graph
        counts["new_kernels"] = _replay_kernels(graph.replay)
    return dict(pair, **counts)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("exec_scatter_mailbox_variants: no CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    proc = start_build()
    _ext.build()
    finish_build(proc)
    dev = "cuda"
    res = {"k8": {}, "k23": {}}
    recs = (smoke.Recorder(tk), smoke.Recorder(tk))
    smoke.frontier_batch(dev, False, recs)
    burn = smoke.Recorder(tk, names=("exec_scatter",))
    with burn:
        smoke.exec_burn(dev, 400)
    for label, rec in (("exec_burn", burn), ("frontier_batch_b", recs[1])):
        res["k8"][label] = k8_pair(rec.get("exec_scatter")[0])
    vmesh = pm.make_mesh(devices=["cuda:0"] * 8)
    S = vmesh.shape["data"]
    mrec = smoke.Recorder(tk, names=("sharded_protocol_tick",),
                          keep=lambda _n, _a, kw: kw.get("mailbox")
                          is not None)
    mkw = dict(nodes=256, rf=5, concurrency=24, megakernel=True,
               device_messages=True, sharded=True, mesh=vmesh)
    run_mesh_burn(6, 30, **mkw)
    with mrec:
        run_mesh_burn(6, 30, **mkw)
    block = smoke._on(mrec.get("sharded_mailbox_route")[0], dev)
    res["k23"]["largest_block_256"] = k23_pair(S, block)
    tier = smoke._shard_mail_block(S, -(-(256 + 1) // S), 64, 384, 64)
    res["k23"]["lanes_1024"] = k23_pair(S, smoke._on(tier, dev))
    res["k23"]["largest_tick_replay"] = tick_pair(
        *mrec.get("sharded_protocol_tick"))
    ok = all(r["bit_equal"] for part in res.values() for r in part.values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
