"""A whole burn through the port against the same burn through the JAX
package: the same seed and config, the JAX BatchDepsResolver on one side
and the port's (on the CPU, its kernels' plain versions) on the other,
must commit the identical history (`collect_log=True` logs every ack and
failure with its txn id, reads and sim time), and the verifier must pass.
The same holds with HostDepsResolver on both sides.
"""
from __future__ import annotations

import pytest

from accord_tpu.ops.resolver import BatchDepsResolver as JaxResolver
from accord_tpu.ops.resolver import HostDepsResolver as JaxHost
from accord_tpu.sim import burn as jax_burn
from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
from accord_tpu_torch.ops.resolver import BatchDepsResolver as PortResolver
from accord_tpu_torch.ops.resolver import HostDepsResolver as PortHost
from accord_tpu_torch.sim import burn as port_burn
from accord_tpu_torch.sim.cluster import ClusterConfig as PortConfig


def _pair(seed, ops, factory_jax, factory_port, created, **kw):
    def port_factory():
        r = factory_port()
        created.append(r)
        return r

    cfg = dict(num_nodes=3, rf=3, deps_batch_window_ms=2.0,
               device_latency_ms=8.0)
    a = jax_burn.run_burn(seed=seed, ops=ops, concurrency=16,
                          collect_log=True,
                          config=JaxConfig(deps_resolver_factory=factory_jax,
                                           **cfg), **kw)
    b = port_burn.run_burn(seed=seed, ops=ops, concurrency=16,
                           collect_log=True,
                           config=PortConfig(
                               deps_resolver_factory=port_factory, **cfg),
                           **kw)
    return a, b


def _check(a, b, ops):
    assert a.log == b.log
    assert len(b.log) == ops and b.lost == 0
    assert b.acked == a.acked > 0


@pytest.mark.parametrize("seed", [3, 4])
def test_batch_resolver_burn_matches_jax(seed):
    created = []
    a, b = _pair(seed, 60, lambda: JaxResolver(num_buckets=128),
                 lambda: PortResolver(num_buckets=128, device="cpu"),
                 created)
    _check(a, b, 60)
    assert sum(r.dispatches for r in created) > 0
    assert sum(r.finalized_decodes for r in created) > 0
    for r in created:
        assert r.host_fallbacks == 0
        assert r.finalize_fallbacks == 0
        assert r.checksum_mismatches == 0


def test_host_resolver_burn_matches_jax():
    a, b = _pair(5, 60, JaxHost, PortHost, [])
    _check(a, b, 60)


@pytest.mark.slow
def test_larger_burn_matches_jax_and_reconciles():
    """A larger leg, and `--reconcile`: the port run twice on one seed
    commits one history."""
    created = []
    a, b = _pair(9, 300, lambda: JaxResolver(num_buckets=128),
                 lambda: PortResolver(num_buckets=128, device="cpu"),
                 created, max_keys_per_txn=4, zipf_theta=0.9)
    _check(a, b, 300)
    assert all(r.host_fallbacks == 0 for r in created)
    again = port_burn.run_burn(
        seed=9, ops=300, concurrency=16, collect_log=True,
        max_keys_per_txn=4, zipf_theta=0.9,
        config=PortConfig(num_nodes=3, rf=3, deps_batch_window_ms=2.0,
                          device_latency_ms=8.0,
                          deps_resolver_factory=lambda: PortResolver(
                              num_buckets=128, device="cpu")))
    assert again.log == b.log
