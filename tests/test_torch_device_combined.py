"""BOTH halves of the port's device data plane at once, under the
adversarial burn: the sharded deps arena (ShardedBatchDepsResolver on the
CPU mesh `make_mesh(devices=["cpu"] * 8)`, data 4 x model 2) resolving
PreAccept/Accept deps AND the exec plane releasing the execute DAG, with
durability truncation, topology churn and network chaos running together
-- the port of tests/test_device_combined.py, every kernel a plain
version. The determinism case also holds the history against the same
burn with the port's single-device resolver.
"""
from __future__ import annotations

import pytest

from accord_tpu_torch.parallel.mesh import make_mesh
from accord_tpu_torch.sim.burn import run_burn
from accord_tpu_torch.sim.cluster import ClusterConfig


def _combined_config(sharded: bool = True):
    from accord_tpu_torch.ops.resolver import (BatchDepsResolver,
                                               ShardedBatchDepsResolver)
    mesh = make_mesh(devices=["cpu"] * 8)
    if sharded:
        factory = lambda: ShardedBatchDepsResolver(  # noqa: E731
            mesh=mesh, num_buckets=256, initial_cap=512)
    else:
        factory = lambda: BatchDepsResolver(  # noqa: E731
            num_buckets=256, initial_cap=512, device="cpu")
    return ClusterConfig(deps_resolver_factory=factory,
                         deps_batch_window_ms=1.0,
                         exec_plane=True, exec_device="cpu",
                         durability=True, durability_interval_ms=400.0)


@pytest.mark.parametrize("seed", (1, 2, 3, 4, 5))
def test_combined_device_plane_burn(seed):
    """Deps arena + exec frontier + durability + churn + chaos, together."""
    r = run_burn(seed, ops=40, key_count=16, concurrency=6, write_ratio=0.8,
                 chaos_drop=0.05, topology_churn=True,
                 churn_interval_ms=1500.0,
                 config=_combined_config())
    assert r.lost == 0
    assert r.acked + r.failed == 40


def test_combined_device_plane_deterministic():
    """The combined device path replays bit-identically, and commits the
    history of the same burn on the single-device resolver."""
    kw = dict(ops=40, key_count=16, concurrency=6, write_ratio=0.8,
              collect_log=True)
    a = run_burn(2, config=_combined_config(), **kw)
    b = run_burn(2, config=_combined_config(), **kw)
    assert a.log == b.log
    assert a.log == run_burn(2, config=_combined_config(False), **kw).log
