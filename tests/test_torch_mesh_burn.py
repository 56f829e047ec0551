"""The cluster tick through the port: the node-lane merged dispatch
(accord_tpu_torch/sim/mesh_burn.py + ops/node_lane.py) against the
per-node launch loop, with the kernels' plain versions on the CPU, and
each history held against the JAX package's run_mesh_burn at the same
seed. Both engine modes share one event schedule, so the differential is
exact: bit-identical event logs. The port of tests/test_mesh_burn.py's
tier-1 cases; the crash-restart case's zero-recompile half is a card
test of zero graph captures (tests/test_torch_gpu.py).
"""
from __future__ import annotations

import pytest

from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
from accord_tpu_torch.sim.mesh_burn import ClusterTickEngine, run_mesh_burn

pytestmark = pytest.mark.mesh_burn


def _counters(rep):
    return {k: v for k, v in rep.counters.items() if not k.endswith("_s")}


def _logs(seed, ops, **kw):
    mesh, emesh = run_mesh_burn(seed, ops, mesh_tick=True, collect_log=True,
                                device="cpu", **kw)
    loop, _ = run_mesh_burn(seed, ops, mesh_tick=False, collect_log=True,
                            device="cpu", **kw)
    ref, _ = jax_mesh_burn(seed, ops, mesh_tick=True, collect_log=True, **kw)
    assert mesh.log == ref.log, "port's node-lane burn != the JAX package's"
    assert _counters(mesh) == _counters(ref)
    return mesh, emesh, loop


def test_mesh_vs_loop_differential_small():
    """Key + range traffic at 4 nodes: the merged node-lane dispatch
    commits the exact event log of the per-node launch loop (and of the
    JAX package), and every plan rode the merge (no fallbacks)."""
    mesh, eng, loop = _logs(11, 90, nodes=4,
                            range_read_ratio=0.15, range_write_ratio=0.1)
    assert mesh.acked == loop.acked == 90
    assert mesh.log == loop.log, "node-lane burn diverged from the loop"
    snap = eng.snapshot()
    assert snap["node_lane_dispatches"] > 0
    assert snap["mesh_tick_fallbacks"] == 0
    assert snap["nodes_per_dispatch"] > 1.0


@pytest.mark.parametrize("seed", [2, 5, 8])
def test_randomized_differential_seeds(seed):
    """A seed sweep of the plain workload: determinism and equivalence are
    properties of the engine, not of one lucky schedule."""
    mesh, _eng, loop = _logs(seed, 50, nodes=3)
    assert mesh.log == loop.log, f"diverged at seed {seed}"


def test_compaction_pin_isolation_across_nodes():
    """Tiny arenas force growth and compaction mid-burn on every node;
    each plan's merge inputs are its encode-time snapshots, so one node's
    arena churn never perturbs another node's lane."""
    mesh, eng, loop = _logs(17, 80, nodes=4, key_count=96,
                            resolver_kwargs=dict(initial_cap=128))
    assert mesh.acked == loop.acked == 80
    assert mesh.log == loop.log
    assert eng.snapshot()["mesh_tick_fallbacks"] == 0


def test_cluster_tick_counters_fold_into_report():
    """The engine's counters ride the burn report (equal to the JAX
    package's), and the padded-row accounting is consistent."""
    rep, eng = run_mesh_burn(13, 40, nodes=3, device="cpu")
    ref, _ = jax_mesh_burn(13, 40, nodes=3)
    for k in ("node_lane_dispatches", "nodes_per_dispatch",
              "node_pad_fraction", "mesh_tick_fallbacks"):
        assert k in rep.counters
        assert rep.counters[k] == ref.counters[k], k
    assert 0.0 <= rep.counters["node_pad_fraction"] < 1.0
    assert rep.counters["node_lane_dispatches"] == \
        eng.snapshot()["node_lane_dispatches"]


def test_engine_reuse_rejected_reentry_safe():
    """note_work during a firing tick arms the NEXT tick (no lost work);
    the engine's dedupe keeps one armed event and the pending map
    clears."""
    eng = ClusterTickEngine()
    rep, eng2 = run_mesh_burn(31, 30, nodes=3, engine=eng, device="cpu",
                              collect_log=True)
    assert eng2 is eng
    assert not eng._pending, "pending work left behind at quiescence"
    assert not eng._armed
    ref, _ = jax_mesh_burn(31, 30, nodes=3, collect_log=True)
    assert rep.log == ref.log


def test_sharded_and_card_defaults():
    """The default device, and the default mesh, is the card, which raises
    here -- for sharded=True with the megakernel too (its resolvers go on
    make_mesh() unless a mesh is given, even with device="cpu")."""
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            run_mesh_burn(1, 10, nodes=3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mesh_burn(1, 10, nodes=3, sharded=True)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_mesh_burn(1, 10, nodes=3, sharded=True, megakernel=True,
                          device="cpu")
