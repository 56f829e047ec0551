"""Time K6 (csrc/range_finalize.cu: `range_finalize_csr`, ONE launch, the
stab words built inside the compaction's tiles) beside the parent's
(`tools/range_finalize_parent.cu`: a stab-word kernel writing the words to
global memory, then the compaction), on the same card in the same process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its entry keeps the shipped C signature, so `parent_kernels()` binds it in
place of the shipped library's in ops/_ext.py's entry cache
(deps_block_variants.bound): every K6 launch made inside, eager or captured
into a CUDA graph (the protocol megakernel's range-finalize stage too), runs
the parent's kernels. The pair helpers are deps_block_variants' (A B B A
interleaved graph replays, three rounds, the median):

    call_pair(call)        a whole range_finalize_csr call
    stage_pair(args, kw)   the call as the megakernel's range-finalize
                           stage (a protocol_tick graph holding it alone)

Run alone it times K6 at a range burn's call (chip_smoke.py's range-mix
burn: 32 entries, 8 subjects, rcap 64, out_cap 256) and at the range
batch's (chip_smoke.py's PreAccept batch with 1,024 range writes and 20%
range subjects), each as a call and as the megakernel's stage, every pair
bit-equal; and beside copies of the shipped source with compaction tiles
of 256 and 1,024 words (RF_CI 1 and 4; shipped: 512) at the batch's call:

    python -m accord_tpu_torch.tools.range_finalize_variants

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
PARENT = pathlib.Path(__file__).resolve().parent / "range_finalize_parent.cu"
SHIPPED = ROOT / "accord_tpu_torch" / "csrc" / "range_finalize.cu"
# the shipped source with other compaction tiles: name -> its words a
# thread (RF_CI; shipped: 2, tiles of 512 words)
TILE_VARIANTS = {"tiles_256": 1, "tiles_1024": 4}
_LIB: list = []


def _so() -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "range_finalize_variants" / "parent.so"


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


@contextlib.contextmanager
def parent_kernels():
    """Inside, K6's entry resolves to the parent's library."""
    from accord_tpu_torch.ops import kernels
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with dbv.bound(lib, {("range_finalize", "range_finalize_csr"):
                         kernels._RANGE_FIN_ARGS}, "parent K6"):
        yield


def call_pair(call, calls: int = dbv.CALLS) -> dict:
    return dbv.call_pair(call, calls, parent=parent_kernels)


def tile_variant_pairs(call) -> dict:
    """The shipped K6 beside each TILE_VARIANTS build of its source (bound
    in place like the parent), on one call: name -> the pair."""
    import torch
    from accord_tpu_torch.ops import _ext, kernels
    out_dir = _ext.BUILD / "range_finalize_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    # the wrapper sizes the zeroed scratch for the shipped tiles: room for
    # a state word a tile at the smallest variant's
    kernels.zeroed_scratch(torch.device("cuda"), 16 << 20)
    procs = {name: subprocess.Popen(
        [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o",
         str(out_dir / f"{name}.so"),
         str(dbv.with_constants(SHIPPED, out_dir / f"{name}.cu",
                                {"RF_CI": ci}))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, ci in TILE_VARIANTS.items()}
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))

        @contextlib.contextmanager
        def variant(lib=lib, name=name):
            with dbv.bound(lib, {("range_finalize", "range_finalize_csr"):
                                 kernels._RANGE_FIN_ARGS}, name):
                yield
        out[name] = dbv.call_pair(call, parent=variant)
    return out


def stage_spec(args, kw) -> tuple:
    """(witness table, protocol_tick's range finalize spec) of a
    range_finalize_csr call's arguments."""
    return args[11], ("range", *args[:6], tuple(args[6:11]), kw["out_cap"])


def stage_pair(args, kw) -> dict:
    """The call as the megakernel's range-finalize stage: a protocol_tick
    graph holding that stage alone, replayed (the parent's side after an
    eager parent call has grown its word scratch)."""
    from accord_tpu_torch.ops import kernels
    wt, spec = stage_spec(args, kw)
    with parent_kernels():
        kernels.range_finalize_csr(*args, **kw)
    return dbv.replay_pair(lambda: kernels.protocol_tick(wt, fins=(spec,)),
                           lambda r: r[2], parent=parent_kernels)


def burn_call(dev):
    """A range burn's K6 call shape (chip_smoke.py's range-mix burn: 32
    entries, 8 subjects, rcap 64, out_cap 256), made from a seed."""
    import numpy as np
    import torch
    from accord_tpu_torch.ops.encoding import WITNESS_TABLE
    rng = np.random.default_rng(14)
    nv, b, rcap = 32, 8, 64
    iv_of = np.sort(rng.integers(0, b, nv)).astype(np.int32)
    iv_s = rng.integers(0, 1000, nv).astype(np.int32)
    iv_e = (iv_s + np.where(rng.random(nv) < 0.5, 1,
                            rng.integers(1, 200, nv))).astype(np.int32)
    st = rng.integers(0, 1000, rcap).astype(np.int32)
    lanes = [iv_of, iv_s, iv_e, rng.random(nv) < 0.9,
             rng.integers(0, 50, (b, 3)).astype(np.int32),
             rng.integers(0, 6, b).astype(np.int32), st,
             (st + rng.integers(1, 200, rcap)).astype(np.int32),
             rng.integers(0, 50, (rcap, 3)).astype(np.int32),
             rng.integers(0, 6, rcap).astype(np.int32),
             rng.random(rcap) < 0.8, np.asarray(WITNESS_TABLE, np.int32)]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in lanes], {"out_cap": 256}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("range_finalize_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    proc = start_build()
    _ext.build()
    finish_build(proc)
    rec = smoke.Recorder(tk, names=("range_finalize_csr",))
    with rec:
        smoke.preaccept_batch("cuda", 10_000, 4096, ranges=1024,
                              range_share=0.2)
    calls = {"range_burn_shape": burn_call("cuda")}
    got = rec.get("range_finalize_csr")
    if got is not None:
        calls["range_batch"] = smoke._on(got, "cuda")
    res = {}
    for label, (args, kw) in calls.items():
        plain = tk.range_finalize_csr_plain(*args, **kw)
        out = tk.range_finalize_csr(*args, **kw)
        res[label] = {
            "nv": int(args[0].shape[0]), "b": int(args[4].shape[0]),
            "rcap": int(args[6].shape[0]), "out_cap": int(kw["out_cap"]),
            "plain_equal": smoke.max_abs_err(out, plain) == 0,
            "call": call_pair(lambda a=args, k=kw: tk.range_finalize_csr(
                *a, **k)),
            "stage": stage_pair(args, kw)}
    if "range_batch" in calls:
        args, kw = calls["range_batch"]
        res["range_batch"]["tile_variants"] = tile_variant_pairs(
            lambda: tk.range_finalize_csr(*args, **kw))
    ok = bool(res) and all(
        r["plain_equal"] and r["call"]["bit_equal"] and r["stage"]["bit_equal"]
        and all(v["bit_equal"] for v in r.get("tile_variants", {}).values())
        for r in res.values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
