"""Time the key body (csrc/deps_block.cuh: K1's `deps_block`, K13's
`node_key_resolve` -- also the one-card sharded tick's key stage -- and
K5's `range_key_block`) beside the parent's
(`tools/deps_block_parent.cu`), on the same card in the same process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its entries keep the shipped C signatures, so `parent_kernels()`
binds them in place of the shipped library's in ops/_ext.py's entry cache:
every launch made inside, eager or captured into a CUDA graph, runs the
parent's kernel (the tick graphs' cache is set aside inside and restored
after, so a tick captured inside is the parent's and is dropped after).

    body_pair(make)    make() -> (launch, out), a body launcher
                       (kernels.resolve_launcher, node_lane.key_launcher):
                       each side's output and device ms (a CUDA graph of
                       CALLS launches, replayed; the sides interleaved A B
                       B A for ROUNDS rounds, the median kept)
    replay_pair(call)  call() -> a protocol_tick / sharded_protocol_tick
                       output: each side's graph replay, timed the same way
    call_pair(call)    a whole wrapper call a CUDA graph may capture (K5's
                       range_deps_resolve): each side's output and device
                       ms, the same way

Run alone it times K1 at chip_smoke.py's PreAccept batch shape (4,096
subjects x 16,384 rows, 1,024 buckets, 10,000 live rows of 4 keys over
1,000) and K13 at its merged tick at 10k in flight (128 blocks of cap
2,048, 4,096 subjects), the sides bit-equal:

    python -m accord_tpu_torch.tools.deps_block_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import contextlib
import ctypes
import json
import pathlib
import re
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
PARENT = pathlib.Path(__file__).resolve().parent / "deps_block_parent.cu"
CALLS = 20
ROUNDS = 3
_LIB: list = []


def _so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "deps_block_variants" / "parent.so"


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


def with_constants(src: pathlib.Path, dst: pathlib.Path,
                   values: dict) -> pathlib.Path:
    """Write a copy of the kernel source `src` to `dst` with each
    `#define NAME value` line of `values` (name -> value) changed: a
    variant of a shipped tile or cache size, built beside the shipped one
    (a copy outside csrc/ still finds its headers through nvcc's -I)."""
    text = src.read_text()
    for name, value in values.items():
        text, hits = re.subn(rf"^#define {name} \S+", f"#define {name} "
                             f"{value}", text, count=1, flags=re.M)
        if hits != 1:
            raise RuntimeError(f"{src.name} defines no {name}")
    dst.parent.mkdir(parents=True, exist_ok=True)
    dst.write_text(text)
    return dst


def _entries() -> dict:
    from accord_tpu_torch.ops import kernels, node_lane
    return {("deps_resolve", "deps_block"): kernels._DEPS_BLOCK_ARGS,
            ("node_resolve", "node_key_resolve"): node_lane._NODE_KEY_ARGS,
            ("range_resolve", "range_key_block"): kernels._RANGE_KEY_ARGS}


@contextlib.contextmanager
def bound(lib, entries: dict, who: str = "parent"):
    """Inside, each (library, entry) of `entries` (-> its argtypes)
    resolves to `lib`'s function of that name in ops/_ext.py's entry
    cache; the tick graphs' cache is set aside inside and restored after
    (a tick captured inside is dropped)."""
    from accord_tpu_torch.ops import _ext, kernels, tick_graph
    saved = {k: _ext._ENTRIES.get(k) for k in entries}
    for (name, entry), argtypes in entries.items():
        fn = getattr(lib, entry)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int

        def f(*args, _fn=fn, _who=f"{who} {entry}"):
            rc = _fn(*args)
            if rc != 0:
                raise RuntimeError(f"{_who}: CUDA error {rc}")
        _ext._ENTRIES[(name, entry)] = f
    graphs = dict(tick_graph._GRAPHS)
    captures = dict(kernels.CAPTURES)
    tick_graph._GRAPHS.clear()
    try:
        yield
    finally:
        for k, f in saved.items():
            if f is None:
                _ext._ENTRIES.pop(k, None)
            else:
                _ext._ENTRIES[k] = f
        for g in tick_graph._GRAPHS.values():
            if g.event is not None:
                g.event.synchronize()
        tick_graph._GRAPHS.clear()
        tick_graph._GRAPHS.update(graphs)
        kernels.CAPTURES.update(captures)


@contextlib.contextmanager
def parent_kernels():
    """Inside, the four body entries resolve to the parent's library."""
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with bound(lib, _entries()):
        yield


def _capture(fn, calls: int):
    """fn() `calls` times in one CUDA graph (after a warm call on a side
    stream) -> the graph."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def _replay_ms(replay, per: int) -> float:
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * per)


def _interleaved(replays: dict) -> dict:
    """name -> {"ms": median, "samples": [...]}: (replay, calls a replay)
    timed A B B A for ROUNDS rounds."""
    names = list(replays)
    samples = {n: [] for n in names}
    for _ in range(ROUNDS):
        for n in names + names[::-1]:
            samples[n].append(_replay_ms(*replays[n]))
    return {n: {"ms": statistics.median(v), "samples": v}
            for n, v in samples.items()}


def _same(a, b) -> bool:
    import torch
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and bool(torch.equal(a, b))


def body_pair(make, calls: int = CALLS, parent=None) -> dict:
    """The shipped and the parent's body on one launcher's inputs: their
    outputs bit-equal, and each side's device ms a call (`parent`: the
    context binding the parent's entries, by default this tool's)."""
    import torch
    launch, out = make()
    with (parent or parent_kernels)():
        p_launch, p_out = make()
        p_launch()
        p_graph = _capture(p_launch, calls)
    launch()
    torch.cuda.synchronize()
    equal = _same(out, p_out)
    graph = _capture(launch, calls)
    t = _interleaved({"new": (graph.replay, calls),
                      "parent": (p_graph.replay, calls)})
    return {"new_ms": t["new"]["ms"], "parent_ms": t["parent"]["ms"],
            "new_samples": t["new"]["samples"],
            "parent_samples": t["parent"]["samples"],
            "bit_equal": equal}


def call_pair(call, calls: int = CALLS, parent=None) -> dict:
    """The shipped and the parent's body inside one whole call (`call()`
    -> its outputs, a tensor or a tuple of tensors): the outputs
    bit-equal, and each side's device ms a call (a CUDA graph of `calls`
    calls)."""
    import torch
    out = call()
    with (parent or parent_kernels)():
        p_out = call()
        p_graph = _capture(call, calls)
    torch.cuda.synchronize()
    equal = _same(out, p_out)
    graph = _capture(call, calls)
    t = _interleaved({"new": (graph.replay, calls),
                      "parent": (p_graph.replay, calls)})
    return {"new_ms": t["new"]["ms"], "parent_ms": t["parent"]["ms"],
            "new_samples": t["new"]["samples"],
            "parent_samples": t["parent"]["samples"],
            "bit_equal": equal}


def replay_pair(call, first, parent=None) -> dict:
    """The shipped and the parent's graph of one tick call (`first` maps
    the call's output to the tensors compared): the replays bit-equal and
    each side's replay ms."""
    import torch
    from accord_tpu_torch.ops import tick_graph
    with (parent or parent_kernels)():
        p_res = call()            # alive while its graph replays into it
        p_graph = next(reversed(tick_graph._GRAPHS.values()))
    res = call()
    torch.cuda.synchronize()
    equal = _same(first(res), first(p_res))
    graph = next(reversed(tick_graph._GRAPHS.values()))
    t = _interleaved({"new": (graph.graph.replay, 1),
                      "parent": (p_graph.graph.replay, 1)})
    return {"new_ms": t["new"]["ms"], "parent_ms": t["parent"]["ms"],
            "new_samples": t["new"]["samples"],
            "parent_samples": t["parent"]["samples"],
            "bit_equal": equal}


def _batch_csr(sw):
    """The subject CSR (subj_of, subj_keys) of packed subject words."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    bits = tk._unpack_bits(sw)
    of, keys = torch.nonzero(bits, as_tuple=True)
    return of.to(torch.int32).contiguous(), keys.to(torch.int32).contiguous()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("deps_block_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.ops import _ext
    proc = start_build()
    _ext.build()
    finish_build(proc)
    dev = "cuda"
    (sw, sb, sk, aw, at, ak, av, wt), _dag = smoke.dense_batch_args(dev,
                                                                 False)
    of, keys = _batch_csr(sw)
    res = {"k1_preaccept_batch": body_pair(lambda: tk.resolve_launcher(
        of, keys, None, sb, sk, None, ((aw, at, ak, av),), wt))}
    key_in = smoke.merged_tick_inputs(dev, False, tk)["key_in"]
    dkey = smoke._on(key_in, dev)
    res["k13_tick_10k"] = body_pair(lambda: nl.key_launcher(*dkey, wt))
    ok = all(r["bit_equal"] for r in res.values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
