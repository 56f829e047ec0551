"""Time K16 (csrc/quorum.cu: `quorum_count`, a cluster of CTAs a tile of
lanes, only fast voters staged) and K7 (csrc/max_conflict.cu:
`max_conflict`, the subject's nonzero words listed before any row load)
beside their parents (`tools/quorum_conflict_parent.cu`), on the same card
in the same process.

The parent's file builds alone (nvcc, seconds: a plain C interface) and
its two entries keep the shipped C signatures, so `parent_kernels()` binds
them in place of the shipped libraries' in ops/_ext.py's entry cache
(deps_block_variants.bound): every K16 and K7 launch made inside, eager or
captured into a CUDA graph (the protocol megakernel's quorum stage too),
runs the parent's kernel. `uncompacted_kernels()` binds K16 without its
compaction of the fast voters (`tools/quorum_uncompacted.cu`: every lane j
staged and compared, its fast bit added) the same way. The pair helpers
are deps_block_variants' (A B B A interleaved graph replays, three rounds,
the median):

    quorum_pair(lanes, qsize)   a whole quorum_count call
    conflict_pair(args)         a whole max_conflict call
    tick_pair(wt, kw)           a protocol_tick graph's replay

Run alone it times K16 at 64, 256, 1,024 and 4,096 lanes (the 10k tick's
lane mix: txns over 50^3 ids, 70% echoed, codes 0 0 0 1 2), each beside
the parent and the uncompacted form, and the 10k tick's whole replay (chip_smoke.py's merged tick) with each K16; K7 at the
inline leg's shape (8 subjects, one live with 2 buckets, cap 4,096, K 128)
and at (64 subjects, cap 16,384, K 1,024); and beside copies of the
shipped sources with other sizes (SIZE_VARIANTS) at 4,096 lanes and at
the inline shape, every pair bit-equal:

    python -m accord_tpu_torch.tools.quorum_conflict_variants

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
PARENT = pathlib.Path(__file__).resolve().parent / "quorum_conflict_parent.cu"
UNCOMPACTED = pathlib.Path(__file__).resolve().parent / "quorum_uncompacted.cu"
CSRC = ROOT / "accord_tpu_torch" / "csrc"
QUORUM_TIERS = (64, 256, 1024, 4096)
# copies of a shipped source with other sizes: name -> (source, {define:
# value}); shipped: QS_MAX 8 (cluster size), QJ 2 lanes j staged a thread,
# MC_RB 4 rows a batch
SIZE_VARIANTS = {"k16_cluster_4": ("quorum", {"QS_MAX": 4}),
                 "k16_qj_4": ("quorum", {"QJ": 4}),
                 "k7_rb_8": ("max_conflict", {"MC_RB": 8})}
_LIB: list = []


def _so(src: pathlib.Path) -> pathlib.Path:
    from accord_tpu_torch.ops import _ext
    return _ext.BUILD / "quorum_conflict_variants" / f"{src.stem}.so"


def start_build():
    """Start nvcc on the parent's file and the uncompacted K16's, at once
    (to overlap the shipped build); finish_build waits for them."""
    from accord_tpu_torch.ops import _ext
    procs = []
    for src in (PARENT, UNCOMPACTED):
        so = _so(src)
        so.parent.mkdir(parents=True, exist_ok=True)
        procs.append((src, subprocess.Popen(
            [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o",
             str(so), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    return procs


def finish_build(procs) -> ctypes.CDLL:
    """The built libraries (the parent's first) in _LIB; the parent's."""
    libs = []
    for src, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        libs.append(ctypes.CDLL(str(_so(src))))
    _LIB[:] = libs
    return _LIB[0]


def _entries(which=("quorum", "max_conflict")) -> dict:
    from accord_tpu_torch.ops import kernels
    args = {"quorum": (("quorum", "quorum_count"), kernels._QUORUM_ARGS),
            "max_conflict": (("max_conflict", "max_conflict"),
                             kernels._MAX_CONFLICT_ARGS)}
    return dict(args[w] for w in which)


@contextlib.contextmanager
def parent_kernels():
    """Inside, K16's and K7's entries resolve to the parent's library."""
    lib = _LIB[0] if _LIB else finish_build(start_build())
    with dbv.bound(lib, _entries(), "parent K16/K7"):
        yield


@contextlib.contextmanager
def uncompacted_kernels():
    """Inside, K16's entry resolves to the uncompacted form's library."""
    if not _LIB:
        finish_build(start_build())
    with dbv.bound(_LIB[1], _entries(("quorum",)), "uncompacted K16"):
        yield


def quorum_pair(lanes, qsize: int, parent=None) -> dict:
    from accord_tpu_torch.ops import kernels as tk
    return dbv.call_pair(lambda: tk.quorum_count(*lanes, qsize),
                         parent=parent or parent_kernels)


def conflict_pair(args, parent=None) -> dict:
    from accord_tpu_torch.ops import kernels as tk
    return dbv.call_pair(lambda: tk.max_conflict(*args),
                         parent=parent or parent_kernels)


def tick_pair(wt, kw) -> dict:
    """The protocol_tick graph of `kw` replayed with each K16 (and K7's
    entry bound alike, which no tick stage calls): its key stage and
    quorum outputs bit-equal, each side's replay ms."""
    from accord_tpu_torch.ops import kernels as tk
    return dbv.replay_pair(lambda: tk.protocol_tick(wt, **kw),
                           lambda o: (o[0], o[4]), parent=parent_kernels)


def tick_lanes(t: int, seed: int, dev):
    """t quorum lanes with the 10k tick's mix (chip_smoke.py's merged
    tick): txns over 50^3 ids, 70% echoing their txn, codes 0 0 0 1 2,
    every lane valid; on `dev`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    txn = rng.integers(0, 50, (t, 3)).astype(np.int32)
    ts = np.where(rng.random((t, 1)) < 0.7, txn, txn + 1).astype(np.int32)
    code = rng.choice([0, 0, 0, 1, 2], t).astype(np.int32)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (txn, ts, code, np.ones(t, bool))]


def conflict_args(b: int, live: int, cap: int, k: int, seed: int, dev):
    """max_conflict's inputs: `live` subjects of 2 buckets (the rest
    all-zero, as a bucketed batch pads), an arena of `cap` rows of ~3
    buckets over k with exact exec_ts ties, every row valid (as the
    resolver passes them); on `dev`."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    nw = k // 32
    bits = np.zeros((cap, k), bool)
    bits[np.arange(cap)[:, None], rng.integers(0, k, (cap, 3))] = True
    subj = np.zeros((b, k), bool)
    subj[np.arange(live)[:, None], rng.integers(0, k, (live, 2))] = True
    ex = rng.integers(-2, 2, (cap, 3)).astype(np.int32)

    def pack(x):
        w = np.packbits(x.reshape(x.shape[0], nw, 32), axis=-1,
                        bitorder="little")
        return np.ascontiguousarray(w).view(np.int32).reshape(-1, nw)
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (pack(subj), pack(bits), ex, np.ones(cap, bool))]


def size_variant_pairs(calls: dict) -> dict:
    """The shipped kernel beside each SIZE_VARIANTS copy of its source
    (bound in place like the parent), on `calls` (source name -> a call):
    name -> the pair."""
    from accord_tpu_torch.ops import _ext
    out_dir = _ext.BUILD / "quorum_conflict_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [_ext.nvcc(), *_ext.NVCC_FLAGS, "-I", str(_ext.CSRC), "-o",
         str(out_dir / f"{name}.so"),
         str(dbv.with_constants(CSRC / f"{src}.cu", out_dir / f"{name}.cu",
                                values))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, values) in SIZE_VARIANTS.items()}
    out = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        src = SIZE_VARIANTS[name][0]
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))

        @contextlib.contextmanager
        def variant(lib=lib, name=name, src=src):
            with dbv.bound(lib, _entries((src,)), name):
                yield
        out[name] = dbv.call_pair(calls[src], parent=variant)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("quorum_conflict_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    proc = start_build()
    _ext.build()
    finish_build(proc)
    dev = "cuda"
    res = {"k16": {}, "k7": {}}
    for t in QUORUM_TIERS:
        lanes = tick_lanes(t, t, dev)
        plain = tk.quorum_count_plain(*(x.cpu() for x in lanes), 2)
        got = tuple(x.cpu() for x in tk.quorum_count(*lanes, 2))
        res["k16"][str(t)] = dict(
            quorum_pair(lanes, 2), geometry=tk.quorum_geometry(t),
            plain_equal=smoke.max_abs_err(got, plain) == 0,
            uncompacted=quorum_pair(lanes, 2, parent=uncompacted_kernels))
    tick = smoke.merged_tick_inputs(dev, False, tk)
    res["k16"]["tick_10k_replay"] = tick_pair(tick["wt"], tick["kw"])
    shapes = {"inline_shape": (8, 1, 4096, 128), "b64_cap16384_k1024":
              (64, 64, 16384, 1024)}
    for label, (b, live, cap, k) in shapes.items():
        args = conflict_args(b, live, cap, k, cap, dev)
        plain = tk.max_conflict_plain(*(x.cpu() for x in args))
        got = tuple(x.cpu() for x in tk.max_conflict(*args))
        res["k7"][label] = dict(
            conflict_pair(args),
            plain_equal=smoke.max_abs_err(got, plain) == 0)
    lanes = tick_lanes(4096, 4096, dev)
    args = conflict_args(8, 1, 4096, 128, 4096, dev)
    res["size_variants"] = size_variant_pairs({
        "quorum": lambda: tk.quorum_count(*lanes, 2),
        "max_conflict": lambda: tk.max_conflict(*args)})
    ok = all(r["bit_equal"] and r.get("plain_equal", True)
             and r.get("uncompacted", {}).get("bit_equal", True)
             for part in ("k16", "k7", "size_variants")
             for r in res[part].values())
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
