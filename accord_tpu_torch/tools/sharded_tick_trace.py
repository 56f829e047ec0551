"""Where the 10k tick's replay spends its device time, kernel by kernel:
the single-device program (kernels.protocol_tick) and the sharded one
(mesh.sharded_protocol_tick) on make_mesh() and on the virtual 4 x 2 mesh
make_mesh(devices=[card] * 8), each as two graphs -- the key stage alone
and with its 128 key finalizes -- replayed between CUDA events (ms a
replay, and the finalize stage as their difference) and traced with
torch.profiler (each device activity's count and microseconds in one
replay). Then the finalize tables' launches alone on the tick's specs
(100 launches a CUDA graph): K2's single-device `finalize_csr_tab` and the
sharded `fin_shard_tab` on both meshes, each held to the plain version.
The inputs are chip_smoke.py's merged tick (128 blocks, 30,000 live rows,
4,096 subjects):

    python -m accord_tpu_torch.tools.sharded_tick_trace

Needs a card and nvcc. Prints the card line and one JSON object.
"""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def _replay(call):
    """(replay ms, the call's outputs, the graph) of the graph `call`
    replays (its outputs kept alive while it replays)."""
    import torch

    import chip_smoke as smoke
    from accord_tpu_torch.ops import tick_graph
    out = call()
    torch.cuda.synchronize()
    graph = next(reversed(tick_graph._GRAPHS.values())).graph
    return smoke.time_ms(graph.replay, 20, True), out, graph


def kernels_of(replay, top: int = 12) -> dict:
    """name -> [count, device us] of the device activities one call of
    `replay` shows in a torch.profiler trace, the largest first."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    replay()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        replay()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0][:60]
            c, us = out.get(name, (0, 0.0))
            out[name] = (c + 1, us + e.device_time_total)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1])[:top])


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("sharded_tick_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as smoke
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    t = smoke.merged_tick_inputs("cuda", False, tk)
    wt, key_in, fins = t["wt"], t["key_in"], tuple(t["fins"])
    vmesh = pm.make_mesh(devices=["cuda:0"] * 8)
    real = pm.make_mesh()
    res = {}
    for label, tick in (
            ("single", lambda **kw: tk.protocol_tick(wt, key_in=key_in, **kw)),
            ("make_mesh", lambda **kw: pm.sharded_protocol_tick(
                real, wt, key_in=key_in, **kw)),
            ("virtual_4x2", lambda **kw: pm.sharded_protocol_tick(
                vmesh, wt, key_in=key_in, **kw))):
        k_ms, _k, gk = _replay(tick)
        f_ms, _f, gf = _replay(lambda: tick(fins=fins))
        res[label] = {"key_ms": k_ms, "key_fins_ms": f_ms,
                      "fin_stage_ms": f_ms - k_ms,
                      "key_kernels": kernels_of(gk.replay),
                      "key_fins_kernels": kernels_of(gf.replay)}
    specs = smoke.key_fin_specs(tk, wt, t["kw"])
    want = tk.finalize_csr_tab_plain(specs)
    launch, outs = tk.fin_tab_launcher(specs)
    launch()
    res["finalize_csr_tab"] = {"graph_ms": smoke.graph_ms(launch),
                               "max_abs_err": smoke.max_abs_err(outs, want)}
    for label, m in (("make_mesh", real), ("virtual_4x2", vmesh)):
        launch, outs = pm.sharded_finalize_tab_launcher(m, specs)
        launch()
        res[f"fin_shard_tab_{label}"] = {
            "graph_ms": smoke.graph_ms(launch),
            "max_abs_err": smoke.max_abs_err(outs, want)}
    print(smoke.card_line(True))
    print(json.dumps(res))
    return 0 if all(r["max_abs_err"] == 0 for k, r in res.items()
                    if "graph_ms" in r) else 1


if __name__ == "__main__":
    sys.exit(main())
