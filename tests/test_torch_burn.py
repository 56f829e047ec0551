"""A whole burn through the port against the same burn through the JAX
package: the same seed and config, the JAX BatchDepsResolver on one side
and the port's (on the CPU, its kernels' plain versions) on the other,
must commit the identical history (`collect_log=True` logs every ack and
failure with its txn id, reads and sim time), and the verifier must pass.
The same holds with HostDepsResolver on both sides, for a range mix with
durability rounds (range reads and writes, and the range sync points the
rounds issue), and in inline mode (no batch window), where max_conflict
runs on the device.
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


def _pair(seed, ops, factory_jax, factory_port, created, cfg=None, **kw):
    def port_factory():
        r = factory_port()
        created.append(r)
        return r

    cfg = cfg or dict(num_nodes=3, rf=3, deps_batch_window_ms=2.0,
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


def test_range_mix_with_durability_matches_jax():
    """Range reads and writes with durability rounds on: every range
    registration, range subject and sync point goes through the port's
    range arena and range kernels, and the history is the JAX package's."""
    created = []
    cfg = dict(num_nodes=3, rf=3, deps_batch_window_ms=2.0,
               device_latency_ms=8.0, durability=True,
               durability_interval_ms=400.0)
    a, b = _pair(7, 70, lambda: JaxResolver(num_buckets=128),
                 lambda: PortResolver(num_buckets=128, device="cpu"),
                 created, cfg=cfg, range_read_ratio=0.1,
                 range_write_ratio=0.2)
    _check(a, b, 70)
    assert sum(r.range_subject_device_decodes for r in created) > 0
    assert sum(ar.ranges.count for r in created
               for ar in r._arenas.values()) > 0
    for r in created:
        assert r.host_fallbacks == 0
        assert r.range_fallbacks == 0
        assert r.finalize_fallbacks == 0
        assert r.checksum_mismatches == 0


def test_inline_range_reads_match_host_and_jax(monkeypatch):
    """The port's twin of the JAX package's inline range-read
    differential: no batch window, so every deps query resolves
    synchronously and max_conflict runs on the device; the host resolver,
    the JAX resolver and the port commit one history."""
    from accord_tpu_torch.ops import kernels as tk
    calls = []
    real = tk.max_conflict

    def counted(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(tk, "max_conflict", counted)
    created = []
    cfg = dict(deps_batch_window_ms=None)
    a, b = _pair(11, 80, lambda: JaxResolver(num_buckets=128),
                 lambda: PortResolver(num_buckets=128, device="cpu"),
                 created, cfg=cfg, range_read_ratio=0.25)
    host = port_burn.run_burn(seed=11, ops=80, concurrency=16,
                              collect_log=True, range_read_ratio=0.25,
                              config=PortConfig(
                                  deps_resolver_factory=PortHost, **cfg))
    assert a.log == b.log == host.log
    assert b.acked == 80 and b.lost == 0
    assert all(r.host_fallbacks == 0 for r in created)
    assert len(calls) > 0      # the inline path ran the max_conflict query


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


@pytest.mark.slow
def test_range_mix_bench_config_guard_trips_match_jax():
    """bench.py's bench_range_mix leg (5 nodes, 10% range reads and
    writes, durability every 1000 ms, 400 ops, seed 21) on both packages:
    one history, and the same counters -- including the sequence-guard
    trips (finalize_fallbacks 10, legacy_decodes 2 at this seed) that
    registrations widening a key row or freeing range rows mid-flight
    cause in the reference too, since its mutation fence covers only
    truncate and prune."""
    counters = ("host_fallbacks", "range_fallbacks", "finalize_fallbacks",
                "legacy_decodes", "checksum_mismatches", "dispatches",
                "finalized_decodes", "range_subject_device_decodes")
    cfg = dict(num_nodes=5, rf=3, deps_batch_window_ms=2.0,
               device_latency_ms=8.0, device_poll_ms=1.0, durability=True,
               durability_interval_ms=1000.0, timeout_ms=8000.0,
               preaccept_timeout_ms=8000.0, progress_stall_ms=5000.0)
    legs = []
    for burn, config, make in (
            (jax_burn, JaxConfig, lambda: JaxResolver(
                num_buckets=1024, initial_cap=2048, max_dispatch=256)),
            (port_burn, PortConfig, lambda: PortResolver(
                num_buckets=1024, initial_cap=2048, max_dispatch=256,
                device="cpu"))):
        created = []

        def factory(make=make, created=created):
            r = make()
            created.append(r)
            return r

        rep = burn.run_burn(21, ops=400, key_count=16, zipf_theta=0.99,
                            write_ratio=0.6, range_read_ratio=0.1,
                            range_write_ratio=0.1, collect_log=True,
                            config=config(deps_resolver_factory=factory,
                                          **cfg))
        legs.append((rep, {k: sum(int(getattr(r, k)) for r in created)
                           for k in counters}))
    (a, ca), (b, cb) = legs
    assert a.log == b.log and b.lost == 0
    assert ca == cb
    assert cb["host_fallbacks"] == cb["range_fallbacks"] == 0
    assert cb["finalize_fallbacks"] == 10 and cb["legacy_decodes"] == 2
