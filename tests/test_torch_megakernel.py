"""The protocol megakernel through the port (kernels.protocol_tick, the
megakernel mode of sim/mesh_burn.ClusterTickEngine), with the plain
versions on the CPU: ONE program per cluster tick against the unfused
merge and the per-node loop, each history and counter set held against
the JAX package's megakernel burn at the same seed. The port of
tests/test_megakernel.py's tier-1 cases and of
tests/test_exec_frontier.py's exec-in-megakernel case.
"""
from __future__ import annotations

import numpy as np
import pytest

from accord_tpu.sim.mesh_burn import run_mesh_burn as jax_mesh_burn
from accord_tpu_torch.sim.mesh_burn import run_mesh_burn

pytestmark = pytest.mark.megakernel


def _counters(rep):
    return {k: v for k, v in rep.counters.items() if not k.endswith("_s")}


def _legs(seed, ops, **kw):
    mega, eng = run_mesh_burn(seed, ops, mesh_tick=True, megakernel=True,
                              collect_log=True, device="cpu", **kw)
    unfused, _ = run_mesh_burn(seed, ops, mesh_tick=True, collect_log=True,
                               device="cpu", **kw)
    ref, _ = jax_mesh_burn(seed, ops, mesh_tick=True, megakernel=True,
                           collect_log=True, **kw)
    assert mega.log == ref.log, "port's megakernel burn != the JAX package's"
    assert _counters(mega) == _counters(ref)
    return mega, eng, unfused


def test_megakernel_vs_unfused_key_range():
    """Key + range traffic: the fused program commits the exact event log
    of the unfused merge and of the per-node loop, every dispatching tick
    costing exactly one program launch."""
    kw = dict(nodes=4, range_read_ratio=0.2, range_write_ratio=0.1)
    mega, eng, unfused = _legs(9, 40, **kw)
    loop, _ = run_mesh_burn(9, 40, mesh_tick=False, collect_log=True,
                            device="cpu", **kw)
    assert mega.log == unfused.log == loop.log
    snap = eng.snapshot()
    assert snap["megakernel_dispatches"] > 0
    assert snap["launches_per_tick"] == 1.0, snap
    assert snap["mesh_tick_fallbacks"] == 0


def test_protocol_tick_quorum_count():
    """The fused quorum stage: votes count SUCCESS lanes that echoed
    their txn id, per distinct txn, against the electorate majority;
    padding and failed lanes are excluded."""
    import torch

    from accord_tpu_torch.ops.encoding import WITNESS_TABLE
    from accord_tpu_torch.ops.kernels import protocol_tick
    t1, t2 = (1, 10, 3), (1, 11, 4)
    txn = np.array([t1, t1, t2, t1, (0, 0, 0)], np.int32)
    ts = np.array([t1, t1, t2, (1, 99, 5), (0, 0, 0)], np.int32)
    code = np.array([0, 0, 0, 0, 0], np.int32)
    valid = np.array([True, True, True, True, False])
    fast, votes, met = protocol_tick(torch.from_numpy(WITNESS_TABLE),
                                     quorum=(txn, ts, code, valid),
                                     quorum_size=2)[4]
    assert fast.tolist() == [True, True, True, False, False]
    assert votes.tolist()[:3] == [2, 2, 1]
    assert met.tolist() == [True, True, False, False, False]


@pytest.mark.slow
def test_exec_megakernel_bit_identical():
    """Standalone compact coordinator vs exec-in-megakernel staging: the
    same history (and the JAX package's), launches_per_tick == 1.0 with
    exec traffic included, exec blocks riding the fused launches."""
    base = dict(ops=40, nodes=4, rf=3, stores_per_node=2, key_count=24,
                concurrency=8, collect_log=True, exec_plane=True,
                exec_compact=True)
    r0, _ = run_mesh_burn(13, megakernel=True, device="cpu", **base)
    r1, _ = run_mesh_burn(13, megakernel=True, exec_in_megakernel=True,
                          device="cpu", **base)
    ref, _ = jax_mesh_burn(13, megakernel=True, exec_in_megakernel=True,
                           **base)
    assert r0.log == r1.log == ref.log
    assert _counters(r1) == _counters(ref)
    assert r1.counters["launches_per_tick"] == 1.0
    assert r1.counters["exec_scan_blocks"] > 0
    assert r1.counters.get("exec_coord.staged_blocks", 0) > 0
    assert r1.counters.get("exec_coord.compact_fallbacks", 0) == 0
