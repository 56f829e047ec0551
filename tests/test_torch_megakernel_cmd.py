"""The protocol megakernel through the port, continued
(tests/test_torch_megakernel.py holds the rest; the cases are split over
files so that test workers spread them): the command plane's deferred
spans riding the quorum stage, and the mixed-config fallback, each
history held against the JAX package's.
"""
from __future__ import annotations

import itertools
import logging

import pytest

from accord_tpu_torch.sim.mesh_burn import ClusterTickEngine
from tests.test_torch_megakernel import _legs

pytestmark = pytest.mark.megakernel


def test_megakernel_cmd_plane_authoritative():
    """With the command plane authoritative, the drains defer PreAccept
    spans to the host twin and their lanes reach the quorum stage: the
    history is the unfused path's (which dispatches cmd_tick spans
    synchronously) and the JAX package's, with equal fast-path counts and
    deferred-span counters."""
    kw = dict(nodes=3, cmd_plane=True, cmd_plane_authoritative=True)
    mega, eng, unfused = _legs(13, 32, **kw)
    assert mega.log == unfused.log
    snap = eng.snapshot()
    assert snap["launches_per_tick"] == 1.0, snap
    assert snap["fastpath_quorum_txns"] > 0
    assert mega.counters["cmd_deferred_spans"] > 0


def test_mixed_resolver_config_falls_back_warns_once(caplog):
    """Resolvers that disagree on num_buckets cannot merge: their plans
    launch unfused (counted in mesh_tick_fallbacks), the engine logs the
    mismatch once per signature, and the history is the per-node loop's
    and the JAX package's over the same mixed factory."""
    from accord_tpu.ops.resolver import BatchDepsResolver as JaxResolver
    from accord_tpu.sim.burn import run_burn as jax_run_burn
    from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
    from accord_tpu.sim.mesh_burn import ClusterTickEngine as JaxEngine
    from accord_tpu_torch.ops.resolver import BatchDepsResolver
    from accord_tpu_torch.sim.burn import run_burn
    from accord_tpu_torch.sim.cluster import ClusterConfig

    def burn(megakernel, mesh_tick=True, jax=False):
        eng = (JaxEngine if jax else ClusterTickEngine)(
            mesh_tick=mesh_tick, megakernel=megakernel)
        eng.quorum_size = 2
        counter = itertools.count()

        def factory():
            nb = 128 if next(counter) % 2 == 0 else 256
            if jax:
                return eng.adopt(JaxResolver(num_buckets=nb))
            return eng.adopt(BatchDepsResolver(num_buckets=nb, device="cpu"))

        cfg = (JaxConfig if jax else ClusterConfig)(
            num_nodes=4, rf=3, num_shards=4, stores_per_node=2,
            deps_resolver_factory=factory, deps_batch_window_ms=2.0,
            device_latency_ms=4.0)
        rep = (jax_run_burn if jax else run_burn)(
            29, 40, nodes=4, rf=3, key_count=32, concurrency=12, config=cfg,
            collect_log=True)
        return rep, eng

    with caplog.at_level(logging.WARNING, "accord_tpu_torch.sim.mesh_burn"):
        mega, eng = burn(True)
    warns = [r for r in caplog.records if "cannot merge" in r.message]
    sigs = {(r.args[0], r.args[1], r.args[2], r.args[3]) for r in warns}
    assert warns, "heterogeneous config never logged"
    assert len(warns) == len(sigs), "config mismatch logged more than once"
    loop, _ = burn(False, mesh_tick=False)
    mesh, _ = burn(False)
    ref, _ = burn(True, jax=True)
    assert mega.log == loop.log == mesh.log == ref.log
    assert eng.snapshot()["mesh_tick_fallbacks"] > 0
