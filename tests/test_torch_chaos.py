"""Device-plane chaos through the port: the seeded DeviceFaultPlane (the
port's copy of ops/fault_plane.py) injects dispatch exceptions, stuck
harvests, corrupted finalize readbacks and out-cap overflow storms into
the port's BatchDepsResolver (on the CPU, its kernels' plain versions).

The fault handling (bounded retries, the harvest watchdog, the checksum
lane, the health ladder and its probation canaries, the overflow bump)
must stay invisible to simulated state: the chaos burn commits the same
history as the JAX package's chaos burn of the same seed and as the
port's own fault-free burn, with the same per-kind ledgers -- also with
range traffic, where faults land on the range lanes' finalize results.
"""
from __future__ import annotations

import pytest

from accord_tpu.ops.resolver import BatchDepsResolver as JaxResolver
from accord_tpu.sim import burn as jax_burn
from accord_tpu.sim.cluster import ClusterConfig as JaxConfig
from accord_tpu_torch.ops.fault_plane import FAULT_KINDS
from accord_tpu_torch.ops.resolver import BatchDepsResolver as PortResolver
from accord_tpu_torch.sim import burn as port_burn
from accord_tpu_torch.sim.cluster import ClusterConfig as PortConfig

pytestmark = pytest.mark.chaos

CHAOS_RATES = {"dispatch_exc_rate": 0.08, "stuck_rate": 0.08,
               "corrupt_rate": 0.08, "overflow_rate": 0.03}
LEDGER = ("device_faults_injected", "checksum_mismatches",
          "device_watchdog_trips", "device_retries", "quarantine_entries",
          "quarantine_exits", "device_canaries", "degraded_dispatches",
          "finalize_fallbacks", "host_fallbacks")


def _leg(burn, config, make, chaos, **traffic):
    resolvers = []

    def factory():
        r = make()
        resolvers.append(r)
        return r

    cfg = config(deps_resolver_factory=factory, deps_batch_window_ms=2.0,
                 device_latency_ms=8.0)
    rep = burn.run_burn(31, ops=120, key_count=8, concurrency=8,
                        write_ratio=0.7, device_chaos=chaos,
                        device_fault_rates=CHAOS_RATES if chaos else None,
                        collect_log=True, config=cfg, **traffic)
    ledger = {k: sum(int(getattr(r, k)) for r in resolvers) for k in LEDGER}
    return rep, ledger


def test_chaos_burn_matches_jax_and_fault_free():
    port, port_ledger = _leg(
        port_burn, PortConfig,
        lambda: PortResolver(num_buckets=128, device="cpu"), True)
    ref, ref_ledger = _leg(jax_burn, JaxConfig,
                           lambda: JaxResolver(num_buckets=128), True)
    clean, clean_ledger = _leg(
        port_burn, PortConfig,
        lambda: PortResolver(num_buckets=128, device="cpu"), False)

    assert port.lost == 0 and port.failed == 0
    assert port.log == ref.log
    assert port.log == clean.log, "chaos changed the committed history"
    assert port.device_faults == ref.device_faults
    assert all(port.device_faults[k] > 0 for k in FAULT_KINDS)
    assert port_ledger == ref_ledger
    inj = port.device_faults
    assert port_ledger["device_faults_injected"] == sum(inj.values())
    assert port_ledger["checksum_mismatches"] == inj["corrupt"]
    assert port_ledger["finalize_fallbacks"] == \
        inj["corrupt"] + inj["overflow"]
    assert port_ledger["quarantine_entries"] > 0
    assert port_ledger["quarantine_exits"] > 0
    assert port_ledger["device_canaries"] > 0
    assert clean_ledger["device_faults_injected"] == 0
    assert clean_ledger["host_fallbacks"] == 0


def test_chaos_burn_with_range_traffic_matches_jax_and_fault_free():
    ranges = dict(range_read_ratio=0.1, range_write_ratio=0.1)
    port, port_ledger = _leg(
        port_burn, PortConfig,
        lambda: PortResolver(num_buckets=128, device="cpu"), True, **ranges)
    ref, ref_ledger = _leg(jax_burn, JaxConfig,
                           lambda: JaxResolver(num_buckets=128), True,
                           **ranges)
    clean, clean_ledger = _leg(
        port_burn, PortConfig,
        lambda: PortResolver(num_buckets=128, device="cpu"), False,
        **ranges)
    assert port.lost == 0
    assert port.log == ref.log
    assert port.log == clean.log, "chaos changed the committed history"
    assert port.device_faults == ref.device_faults
    assert port_ledger == ref_ledger
    assert port_ledger["checksum_mismatches"] == port.device_faults["corrupt"]
    assert clean_ledger["device_faults_injected"] == 0
    assert clean_ledger["host_fallbacks"] == 0
    assert clean_ledger["finalize_fallbacks"] == 0
