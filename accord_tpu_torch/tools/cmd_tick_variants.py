"""Time K10 (`csrc/cmd_tick.cu`) with each side of its one fork.

K10 keeps its chains, kid lanes and staged outputs in dynamic shared
memory up to CMD_TICK_SMEM_MAX bytes (global memory above: tier 4096).
This script builds two libraries of the same source -- shipped, and with
everything in global memory (-DCMD_TICK_SMEM_MAX=0) -- and replays one
recorded dispatch of each op tier through the `cmd_tick` wrapper with
each library in turn: the cmd burn's first tier-8 dispatch, the cmd
batch's first tier-512 dispatch (the inputs chip_smoke.py replays) and
one 4096-op PreAccept span (the tier whose chains never fit shared
memory). Every variant must be bit-equal to the plain version; the wall
times are CUDA-event means of the wrapper called in a loop, the device
times 100 calls in one CUDA graph, the variants interleaved (A B B A,
three rounds) and the median kept.

    python -m accord_tpu_torch.tools.cmd_tick_variants

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
VARIANTS = {"shipped": (), "global_chains": ("-DCMD_TICK_SMEM_MAX=0",)}
ITERS = {8: 200, 512: 50, 4096: 10}


def build_variants() -> dict:
    """name -> loaded library, all compiled in parallel."""
    from accord_tpu_torch.ops import _ext
    out_dir = _ext.BUILD / "cmd_tick_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = _ext.CSRC / "cmd_tick.cu"
    procs = {}
    for name, flags in VARIANTS.items():
        so = out_dir / f"{name}.so"
        procs[name] = (so, subprocess.Popen(
            [_ext.nvcc(), *_ext.NVCC_FLAGS, *flags, "-I", str(_ext.CSRC),
             "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def record(smoke, tk) -> dict:
    """op tier -> (args, kwargs) of one recorded cmd_tick call."""
    from accord_tpu_torch.ops.cmd_plane import CmdOp, CmdPlane
    calls = {}
    rec = smoke.Recorder(tk, cmd_tier=8)
    with rec:
        smoke.burn("cuda", 60, [], cmd_plane=True, cmd_device="cuda")
    calls[8] = rec.get("cmd_tick")
    rec = smoke.Recorder(tk, cmd_tier=512)
    with rec:
        smoke.cmd_batch("cuda", 10_000)
    calls[512] = rec.get("cmd_tick")
    _c, node, store = smoke._one_store()
    plane = CmdPlane(store, initial_cap=16_384, key_cap=1024, kpad=4,
                     apply_to_store=False, device="cuda")
    rec = smoke.Recorder(tk, cmd_tier=4096)
    with rec:
        plane.eval_batch([CmdOp.preaccept(tid, part, route) for tid, route,
                          part in smoke._cmd_stream(node, store, 4096, 11)])
    calls[4096] = rec.get("cmd_tick")
    for tier, got in calls.items():
        smoke.check(got is not None, f"no cmd_tick call at tier {tier}")
    return calls


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("cmd_tick_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import _ext
    from accord_tpu_torch.ops import kernels as tk
    card = smoke.card_line(True)
    libs = build_variants()
    calls = record(smoke, tk)
    shipped = _ext.lib("cmd_tick")
    names = list(VARIANTS)
    order = (names + names[::-1]) * 3
    report = {"card": card, "tiers": {}}

    def use(lib) -> None:
        # the wrapper resolves its C entry once: drop it with the library
        _ext._LIBS["cmd_tick"] = lib
        _ext._ENTRIES.pop(("cmd_tick", "cmd_tick"), None)
    try:
        for tier, (args, kw) in calls.items():
            plain = tk.cmd_tick_plain(*args, **kw)
            wall = {n: [] for n in names}
            dev = {n: [] for n in names}
            for n in names:
                use(libs[n])
                err = smoke.max_abs_err(tk.cmd_tick(*args, **kw), plain)
                smoke.check(err == 0, f"{n} at tier {tier}: differs from "
                            f"the plain version by {err}")
            for n in order:
                use(libs[n])
                wall[n].append(smoke.time_ms(
                    lambda: tk.cmd_tick(*args, **kw), ITERS[tier], True))
                dev[n].append(smoke.graph_ms(
                    lambda: tk.cmd_tick(*args, **kw)))
            report["tiers"][str(tier)] = {
                "kpad": int(args[14].shape[1]),
                "promote": bool(kw.get("promote")),
                "ms": {n: statistics.median(v) for n, v in wall.items()},
                "device_ms": {n: statistics.median(v)
                              for n, v in dev.items()},
                "ms_samples": wall, "device_ms_samples": dev}
    finally:
        use(shipped)
    print(card)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
