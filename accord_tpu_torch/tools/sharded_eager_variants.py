"""Time each eager sharded entry's one-card form (parallel/mesh.py
`one_card_*`: its single-device twin's launches -- K1, K5, K13, K14, K2 --
straight into the result) beside its parent, the per-shard form
(`per_shard_*`: a launch a (store, data, model) shard, then K22's fold,
concat, scan and merge), on the same card in the same process. The parent
stays in the package as the across-card form, so nothing is built here.

    entry_pair(mesh, name, args, kw)  one call of entry `name` (a form's
                              suffix: deps_resolve, range_deps_resolve,
                              fused_deps_resolve, fused_range_deps_resolve,
                              finalize_csr) in each form on the same
                              inputs: the outputs bit-equal; device ms a
                              call (CALLS calls in one CUDA graph, every
                              lane uploaded before the capture: K13's and
                              K14's block tables too, whose launcher's
                              launch is captured), wall ms a call (CUDA
                              events around ITERS eager calls) beside the
                              single-device twin's; the sides interleaved
                              A B B A for ROUNDS rounds, the median kept
    finalize_candidates(mesh, args, kw)  the two one-card finalizes that are
                              bit-identical by contract: K2's
                              finalize_csr (shipped) and the sharded
                              finalize table over one spec
                              (mesh.sharded_finalize_tab, its data-shard
                              records packed on the host every call),
                              device and wall ms interleaved
    burns(dev, rehearse)      the sharded key, range-mix and mesh burns
                              with each form (the parent by making every
                              entry take its per-shard form), beside the
                              single-device burns: wall s and launches per
                              kernel name, the histories equal; each
                              entry's calls and largest call (new form)

Run alone it runs the burns, then the pairs at each burn's largest
recorded call of each entry and at the PreAccept batch's (chip_smoke.py's
10k-in-flight batch, key-only and with range writes: the shapes of
chip_smoke's sharded entry rows) on the virtual 4 x 2 mesh, and at the
batch also on make_mesh(), and the finalize candidates at the key burn's,
range burn's and batch's largest finalizes:

    python -m accord_tpu_torch.tools.sharded_eager_variants

Needs a card; prints the card line and one JSON object. `--rehearse` runs
the same legs on the CPU at a tiny size, one sample a timer (the one-card
forms' twins' plain versions against the per-shard plain chain, wall times
of the host only, no device ms) and prints the JSON object.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
CALLS = 100
ITERS = 20
ROUNDS = 3
ENTRIES = ("deps_resolve", "range_deps_resolve", "fused_deps_resolve",
           "fused_range_deps_resolve", "finalize_csr")
# each entry's single-device twin (module, function)
TWINS = {"deps_resolve": ("kernels", "deps_resolve"),
         "range_deps_resolve": ("kernels", "range_deps_resolve"),
         "fused_deps_resolve": ("node_lane", "node_fused_deps_resolve"),
         "fused_range_deps_resolve": ("node_lane",
                                      "node_fused_range_deps_resolve"),
         "finalize_csr": ("kernels", "finalize_csr")}
ONE_CARD_FORMS = tuple(f"one_card_{n}" for n in ENTRIES)


def _smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _twin(name):
    import importlib
    mod, fn = TWINS[name]
    return getattr(importlib.import_module(f"accord_tpu_torch.ops.{mod}"),
                   fn)


@contextlib.contextmanager
def forms(one_card: bool):
    """Every eager sharded entry takes its one-card form (new) or its
    per-shard form (the parent), whatever its mesh and inputs (on the CPU
    the one-card form is its twin's plain version)."""
    from accord_tpu_torch.parallel import mesh as pm
    keep = pm._runs_one_card
    pm._runs_one_card = lambda mesh, probe: one_card
    try:
        yield
    finally:
        pm._runs_one_card = keep


def _sync(cuda: bool) -> None:
    if cuda:
        import torch
        torch.cuda.synchronize()


def _wall_ms(fn, cuda: bool, iters: int = ITERS) -> float:
    """ms a call of `iters` eager calls: CUDA events on the card, the
    host's clock on the CPU."""
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _interleaved(timers: dict, rounds: int = ROUNDS) -> dict:
    """name -> {"ms": median, "samples": [...]}: each timer() sampled in
    the order A B .. B A, `rounds` rounds."""
    names = list(timers)
    samples = {n: [] for n in names}
    for _ in range(rounds):
        for n in names + names[::-1]:
            samples[n].append(timers[n]())
    return {n: {"ms": statistics.median(v), "samples": v}
            for n, v in samples.items()}


def _same(a, b) -> bool:
    import torch
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a.shape == b.shape and a.dtype == b.dtype \
        and bool(torch.equal(a, b))


def _device_work(mesh, name, args, kw):
    """The one-card form's device work as (thunk, kept alive): the whole
    call, except K13's and K14's, whose block tables go up before (the
    thunk is their launcher's launch, K13's with its subject pass)."""
    from accord_tpu_torch.ops import node_lane as nl
    from accord_tpu_torch.parallel import mesh as pm
    if name == "fused_deps_resolve":
        launch, out = nl.key_launcher(*args)
        return (lambda: launch(True)), out
    if name == "fused_range_deps_resolve":
        launch, rp, kp = nl.range_launcher(*args)
        return launch, (rp, kp)
    fn = getattr(pm, f"one_card_{name}")
    return (lambda: fn(mesh, *args, **kw)), None


def entry_pair(mesh, name: str, args, kw=None, iters: int = ITERS,
               rounds: int = ROUNDS) -> dict:
    """The one-card form (new) and the per-shard form (parent) of entry
    `name` on the same inputs: outputs bit-equal (each also = the twin's),
    device ms (card only) and wall ms, interleaved; the twin's wall ms."""
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    kw = dict(kw or {})
    cuda = bool(args[-1].is_cuda) if name != "finalize_csr" \
        else bool(args[0].is_cuda)
    one = getattr(pm, f"one_card_{name}")
    per = getattr(pm, f"per_shard_{name}")
    twin = _twin(name)
    new_out, par_out = one(mesh, *args, **kw), per(mesh, *args, **kw)
    twin_out = twin(*args, **kw)
    _sync(cuda)
    res = {"bit_equal": _same(new_out, par_out)
           and _same(new_out, twin_out),
           "input_mb": sum(t.numel() * t.element_size()
                           for t in _tensors((args, kw))) / 1e6}
    walls = _interleaved({
        "new": lambda: _wall_ms(lambda: one(mesh, *args, **kw), cuda, iters),
        "parent": lambda: _wall_ms(lambda: per(mesh, *args, **kw), cuda,
                                   iters),
        "twin": lambda: _wall_ms(lambda: twin(*args, **kw), cuda, iters)},
        rounds)
    res.update(wall_ms=walls["new"]["ms"],
               parent_wall_ms=walls["parent"]["ms"],
               twin_wall_ms=walls["twin"]["ms"],
               wall_samples={k: v["samples"] for k, v in walls.items()})
    if cuda:
        from accord_tpu_torch.tools import deps_block_variants as dbv
        work, _keep = _device_work(mesh, name, args, kw)
        graph = dbv._capture(work, CALLS)
        p_graph = dbv._capture(lambda: per(mesh, *args, **kw), CALLS)
        t = dbv._interleaved({"new": (graph.replay, CALLS),
                              "parent": (p_graph.replay, CALLS)})
        res.update(device_ms=t["new"]["ms"],
                   parent_device_ms=t["parent"]["ms"],
                   device_samples={k: v["samples"] for k, v in t.items()})
        del graph, p_graph
    before = sum(tk.LAUNCHES.values())
    one(mesh, *args, **kw)
    res["launches"] = sum(tk.LAUNCHES.values()) - before
    before = sum(tk.LAUNCHES.values())
    per(mesh, *args, **kw)
    res["parent_launches"] = sum(tk.LAUNCHES.values()) - before
    _sync(cuda)
    return res


def finalize_candidates(mesh, args, kw, iters: int = ITERS,
                        rounds: int = ROUNDS) -> dict:
    """K2's finalize_csr (the shipped one-card finalize) and the sharded
    finalize table over one spec on the same finalize (`args` and `kw` a
    recorded call's; out_cap the last): bit-equal, device
    ms (card only: each one launch, its table and scratch ready before the
    capture) and wall ms, interleaved."""
    from accord_tpu_torch.parallel import mesh as pm
    spec = tuple(args) + tuple(int(v) for v in (kw or {}).values())
    cuda = bool(args[0].is_cuda)

    def k2():
        return pm.one_card_finalize_csr(mesh, *spec)

    def tab():
        return pm.sharded_finalize_tab(mesh, [spec])[0]
    res = {"bit_equal": _same(k2(), tab())}
    walls = _interleaved({"k2": lambda: _wall_ms(k2, cuda, iters),
                          "shard_tab": lambda: _wall_ms(tab, cuda, iters)},
                         rounds)
    res.update(k2_wall_ms=walls["k2"]["ms"],
               shard_tab_wall_ms=walls["shard_tab"]["ms"])
    if cuda:
        from accord_tpu_torch.tools import deps_block_variants as dbv
        launch, outs = pm.sharded_finalize_tab_launcher(mesh, [spec])
        launch()
        g_k2 = dbv._capture(k2, CALLS)
        g_tab = dbv._capture(launch, CALLS)
        t = dbv._interleaved({"k2": (g_k2.replay, CALLS),
                              "shard_tab": (g_tab.replay, CALLS)})
        res.update(k2_device_ms=t["k2"]["ms"],
                   shard_tab_device_ms=t["shard_tab"]["ms"],
                   bit_equal=res["bit_equal"] and _same(k2(), outs[0]))
        del g_k2, g_tab
    _sync(cuda)
    return res


def _tensors(xs):
    import torch
    if torch.is_tensor(xs):
        yield xs
    elif isinstance(xs, (tuple, list)):
        for x in xs:
            yield from _tensors(x)
    elif isinstance(xs, dict):
        yield from _tensors(tuple(xs.values()))


def _counts() -> dict:
    from accord_tpu_torch.ops import kernels as tk
    return {k: v for k, v in {**tk.LAUNCHES, **tk.ENTRY_LAUNCHES}.items()
            if v}


def burns(dev: str, sizes=(800, 400, (64, 120))) -> tuple:
    """The sharded key, range-mix and mesh burns on the virtual 4 x 2 mesh
    with the new forms and with the parent's, and the single-device burns
    (`sizes`: the key and range burns' ops, the mesh burn's nodes and ops)
    -> (per leg and form: wall s, launches per kernel name, acked; the new
    run's Recorder of the one-card forms, per leg)."""
    import torch
    from accord_tpu_torch.ops import kernels as tk
    from accord_tpu_torch.parallel import mesh as pm
    from accord_tpu_torch.sim.mesh_burn import run_mesh_burn
    smoke = _smoke()
    cuda = dev != "cpu"
    vmesh = pm.make_mesh(devices=[torch.device(dev) if not cuda
                                  else torch.device("cuda", 0)] * 8)
    kops, rops, (nodes, mops) = sizes
    legs = {
        "key_burn": lambda mesh: smoke.burn(dev, kops, [], mesh=mesh),
        "range_burn": lambda mesh: smoke.range_mix_burn(dev, rops, [],
                                                        mesh=mesh),
        "mesh_burn": lambda mesh: _mesh_burn(run_mesh_burn, dev, nodes, mops,
                                             mesh)}
    out, recs = {}, {}
    for leg, run in legs.items():
        out[leg] = {}
        logs = {}
        for form in ("single", "parent", "new"):
            tk.reset_launches()
            rec = smoke.Recorder(tk, names=ONE_CARD_FORMS)
            ctx = forms(form == "new") if form != "single" \
                else contextlib.nullcontext()
            with ctx, rec:
                rep, wall = run(None if form == "single" else vmesh)
            _sync(cuda)
            logs[form] = rep.log
            out[leg][form] = {"wall_s": wall, "acked": rep.acked,
                              "launches": _counts()}
            if form == "new":
                out[leg][form]["one_card_calls"] = dict(rec.n)
                recs[leg] = rec
        out[leg]["histories_equal"] = \
            logs["single"] == logs["parent"] == logs["new"]
    return out, recs


def _mesh_burn(run_mesh_burn, dev, nodes, ops, mesh):
    t0 = time.perf_counter()
    kw = dict(nodes=nodes, collect_log=True)
    if mesh is None:
        rep, _eng = run_mesh_burn(6, ops, device=dev, **kw)
    else:
        rep, _eng = run_mesh_burn(6, ops, sharded=True, mesh=mesh, **kw)
    return rep, time.perf_counter() - t0


def batch_calls(dev: str, rehearse: bool, data: int) -> dict:
    """The PreAccept batch's calls of each entry (chip_smoke's
    sharded_batches: the 10k-in-flight batch's K1 and K2 calls, as one
    store and as two; its range batch's K5 call, as one store and as two)
    -> name -> (args, kw)."""
    from accord_tpu_torch.ops import kernels as tk
    smoke = _smoke()
    active, subjects = (10_000, 4_096) if not rehearse else (1_000, 256)
    pa_rec = smoke.Recorder(tk, names=("deps_resolve", "finalize_csr"))
    with pa_rec:
        smoke.preaccept_batch(dev, active, subjects)
    pr_rec = smoke.Recorder(tk, names=("range_deps_resolve",))
    with pr_rec:
        smoke.preaccept_batch(dev, active, subjects,
                              ranges=1_024 if not rehearse else 128,
                              range_share=0.2)
    return smoke.sharded_batches(tk, data, pa_rec, pr_rec, pr_rec)


def run(rehearse: bool) -> dict:
    import torch
    from accord_tpu_torch.parallel import mesh as pm
    cuda = torch.cuda.is_available() and not rehearse
    dev = "cuda" if cuda else "cpu"
    if cuda:
        from accord_tpu_torch.ops import _ext
        _ext.build()
    res = {"pairs": {}, "finalize": {}}
    res["burns"], recs = burns(dev, (800, 400, (64, 120)) if not rehearse
                               else (40, 30, (8, 20)))
    t = {} if not rehearse else {"iters": 1, "rounds": 1}
    vmesh = pm.make_mesh(devices=[torch.device("cuda", 0) if cuda
                                  else torch.device("cpu")] * 8)
    real = pm.make_mesh() if cuda else pm.make_mesh(devices=["cpu"])
    batch = batch_calls(dev, rehearse, vmesh.shape["data"])
    for label, rec in recs.items():
        res["pairs"][label] = {}
        for name in ENTRIES:
            got = rec.get(f"one_card_{name}")
            if got is None:
                continue
            (mesh, *args), kw = got
            res["pairs"][label][name] = entry_pair(mesh, name, args, kw,
                                                   **t)
            if name == "finalize_csr" and label != "mesh_burn":
                res["finalize"][label] = finalize_candidates(mesh, args, kw,
                                                             **t)
    for label, mesh in (("batch_virtual_4x2", vmesh),
                        ("batch_make_mesh", real)):
        res["pairs"][label] = {}
        for name in ENTRIES:
            args, kw = batch[name]
            res["pairs"][label][name] = entry_pair(mesh, name, args, kw,
                                                   **t)
    args, kw = batch["finalize_csr"]
    res["finalize"]["preaccept_batch"] = finalize_candidates(vmesh, args, kw,
                                                             **t)
    res["ok"] = all(p["bit_equal"] for part in res["pairs"].values()
                    for p in part.values()) \
        and all(f["bit_equal"] for f in res["finalize"].values()) \
        and all(b["histories_equal"] for b in res["burns"].values())
    return res


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    rehearse = "--rehearse" in argv
    if not rehearse and not torch.cuda.is_available():
        print("sharded_eager_variants: no CUDA device", file=sys.stderr)
        return 1
    res = run(rehearse)
    if not rehearse:
        print(_smoke().card_line(True))
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
