"""Time the range body (csrc/range_block.cuh: K5's `range_resolve`, K14's
`node_range_resolve`, the mesh's range shards, the covered pass) and K3
(csrc/arena_scatter.cu) beside the parent's (`tools/range_block_parent.cu`),
on the same card in the same process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its three entries keep the shipped C signatures, so `parent_kernels()`
binds them in place of the shipped libraries' in ops/_ext.py's entry
cache (deps_block_variants.bound): every launch made inside, eager or
captured into a CUDA graph, runs the parent's kernels. The pair helpers
are deps_block_variants' (A B B A interleaved graph replays, the median):

    call_pair(call)        a whole wrapper call (K3, K5, covered_buckets)
    body_pair(make)        a launcher (node_lane.range_launcher's launch)
    replay_pair(call, f)   a protocol_tick / sharded_protocol_tick graph

Run alone it times K5 at chip_smoke.py's range batch (4,096 subjects,
20% range subjects, 10,000 in-flight writes plus 1,024 range writes) and
K3 at a cap-16,384 arena, the sides bit-equal:

    python -m accord_tpu_torch.tools.range_block_variants

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
PARENT = pathlib.Path(__file__).resolve().parent / "range_block_parent.cu"
_LIB: list = []


def _so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "range_block_variants" / "parent.so"


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
    from accord_tpu_torch.ops import kernels, node_lane
    return {("range_resolve", "range_resolve"): kernels._RANGE_ARGS,
            ("node_resolve", "node_range_resolve"):
                node_lane._NODE_RANGE_ARGS,
            ("arena_scatter", "arena_scatter"): kernels._ARENA_SCATTER_ARGS}


@contextlib.contextmanager
def parent_kernels():
    """Inside, the range side, the covered pass and K3 resolve to the
    parent's library."""
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with dbv.bound(lib, _entries(), "parent range body"):
        yield


def call_pair(call, calls: int = dbv.CALLS) -> dict:
    return dbv.call_pair(call, calls, parent=parent_kernels)


def body_pair(make, calls: int = dbv.CALLS) -> dict:
    return dbv.body_pair(make, calls, parent=parent_kernels)


def replay_pair(call, first) -> dict:
    return dbv.replay_pair(call, first, parent=parent_kernels)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("range_block_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    proc = start_build()
    _ext.build()
    finish_build(proc)
    rec = smoke.Recorder(tk)
    with rec:
        smoke.preaccept_batch("cuda", 10_000, 4096, ranges=1024,
                              range_share=0.2)
    res = {}
    for name in ("range_deps_resolve", "arena_scatter"):
        got = rec.get(name)
        if got is None:
            continue
        args, kw = smoke._on(got, "cuda")
        fn = getattr(tk, name)
        res[name] = call_pair(lambda fn=fn, a=args, k=kw: fn(*a, **k))
    got = rec.get("range_deps_resolve")
    if got is not None:
        # K5's two parts alone: the range side (a fused call of the one
        # range block, every subject its slot's) and the covered pass
        a = smoke._on(got[0], "cuda")
        b = a[3].shape[0]
        zero = torch.zeros(b, dtype=torch.int32, device="cuda")
        res["range_side"] = call_pair(lambda: tk.fused_range_deps_resolve(
            *a[:3], zero, *a[3:6], zero[:1], (tuple(a[6:11]),), zero[:0],
            (), a[15]))
        res["covered"] = call_pair(lambda: tk.covered_buckets(
            *a[:3], b, a[11].shape[1] * 32))
        res["shape"] = {"b": b, "nv": a[0].shape[0],
                        "rcap": a[6].shape[0], "cap": a[11].shape[0]}
    ok = bool(res) and all(r["bit_equal"] for r in res.values()
                           if "bit_equal" in r)
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
