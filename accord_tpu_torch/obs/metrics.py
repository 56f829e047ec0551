"""MetricsRegistry: named counters, gauges, timers, log2 histograms.

One registry instance lives wherever counters used to be scattered as
plain attributes (BatchDepsResolver, ExecPlane, Node, the maelstrom
runner). Existing attribute reads and writes (`resolver.dispatches += 1`,
`resolver.host_hidden_s`) keep working through the `RegCounter` /
`RegTimer` descriptors, which proxy class attributes onto the owning
object's `metrics` registry -- so every legacy call site compiles into a
registry update and `registry.snapshot()` is the single source for bench
JSON.

Histograms use log2 buckets: bucket `b` holds values in [2^b, 2^(b+1)).
Percentile estimates take the geometric midpoint of the covering bucket,
clamped to the observed [min, max] -- within a factor of two of the exact
sample percentile by construction (asserted against numpy in
tests/test_obs.py).
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, Optional, Tuple


class Counter:
    """Monotone-in-spirit integer cell (resets to 0 allowed: legacy code
    assigns as well as increments)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-value-wins float cell (point-in-time readings)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v


class Timer:
    """Accumulated wall seconds (the `*_s` phase counters)."""

    __slots__ = ("name", "total")

    def __init__(self, name: str):
        self.name = name
        self.total = 0.0

    def add(self, dt: float) -> None:
        self.total += dt


class Histogram:
    """Log2-bucket histogram over non-negative samples.

    Bucket index b covers [2^b, 2^(b+1)); zeros land in a dedicated
    bucket. Exact count/sum/min/max ride along, so means are exact and
    percentile estimates are clamped to the observed range."""

    __slots__ = ("name", "buckets", "zeros", "count", "sum", "min", "max")

    def __init__(self, name: str):
        self.name = name
        self.buckets: Dict[int, int] = {}
        self.zeros = 0
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if v <= 0:
            self.zeros += 1
            return
        b = math.frexp(v)[1] - 1  # v in [2^b, 2^(b+1))
        self.buckets[b] = self.buckets.get(b, 0) + 1

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, p: float) -> float:
        """Estimated p-th percentile: geometric midpoint of the bucket the
        cumulative count crosses, clamped to [min, max]."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(self.count * p / 100.0))
        cum = self.zeros
        if cum >= target:
            return 0.0
        est = None
        for b in sorted(self.buckets):
            cum += self.buckets[b]
            if cum >= target:
                est = 2.0 ** (b + 0.5)
                break
        if est is None:  # p beyond the last bucket (float dust): take max
            est = self.max
        return min(max(est, self.min), self.max)

    def merge_from(self, other: "Histogram") -> None:
        for b, n in other.buckets.items():
            self.buckets[b] = self.buckets.get(b, 0) + n
        self.zeros += other.zeros
        self.count += other.count
        self.sum += other.sum
        if other.min is not None and (self.min is None or other.min < self.min):
            self.min = other.min
        if other.max is not None and (self.max is None or other.max > self.max):
            self.max = other.max

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean": round(self.mean, 3),
            "p50": round(self.percentile(50), 3),
            "p95": round(self.percentile(95), 3),
            "p99": round(self.percentile(99), 3),
            "p999": round(self.percentile(99.9), 3),
            "max": round(self.max, 3) if self.max is not None else 0.0,
        }


class MetricsRegistry:
    """Named metric cells, created on first touch; kind mismatches raise."""

    __slots__ = ("_metrics",)

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, kind):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = kind(name)
        elif type(m) is not kind:
            raise TypeError(
                f"metric {name!r} is {type(m).__name__}, not {kind.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def timer(self, name: str) -> Timer:
        return self._get(name, Timer)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def names(self) -> Iterator[str]:
        return iter(sorted(self._metrics))

    def merge_from(self, other: "MetricsRegistry") -> None:
        """Fold another registry into this one (cross-node aggregation:
        counters/timers sum, gauges take the other's value, histograms
        merge bucket-wise)."""
        for name in sorted(other._metrics):
            m = other._metrics[name]
            if isinstance(m, Counter):
                self.counter(name).value += m.value
            elif isinstance(m, Timer):
                self.timer(name).total += m.total
            elif isinstance(m, Gauge):
                self.gauge(name).value = m.value
            elif isinstance(m, Histogram):
                self.histogram(name).merge_from(m)

    def snapshot(self) -> dict:
        """Flat name -> value dict (histograms as {count, mean, p50, p95,
        p99, p999, max} sub-dicts) -- the single source for bench JSON."""
        out = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Counter):
                out[name] = m.value
            elif isinstance(m, Timer):
                out[name] = m.total
            elif isinstance(m, Gauge):
                out[name] = m.value
            else:
                out[name] = m.snapshot()
        return out

    def snapshot_json(self, extra: Optional[dict] = None) -> str:
        """snapshot() as one sorted JSON line -- the shared export behind
        the serve node's periodic stderr metrics dump and bench_serve's
        per-leg reports (machine-parseable, diff-stable key order)."""
        import json
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        return json.dumps(snap, sort_keys=True)


class RegCounter:
    """Class-level descriptor backing a legacy int attribute with a
    registry Counter on the instance's `metrics` registry: existing
    `self.dispatches += 1` statements and `resolver.dispatches` reads
    compile into registry updates unchanged."""

    __slots__ = ("metric",)

    def __init__(self, metric: str):
        self.metric = metric

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return obj.metrics.counter(self.metric).value

    def __set__(self, obj, value) -> None:
        obj.metrics.counter(self.metric).value = value


class RegTimer:
    """RegCounter's float twin, backed by a registry Timer."""

    __slots__ = ("metric",)

    def __init__(self, metric: str):
        self.metric = metric

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return obj.metrics.timer(self.metric).total

    def __set__(self, obj, value) -> None:
        obj.metrics.timer(self.metric).total = float(value)


class CounterDict:
    """Dict-like view over a family of registry counters `prefix.key` --
    backs the `upload_bytes_by_field` breakdown dicts so per-field
    accounting lives in the registry while `d[k] += n` / `d.items()` call
    sites keep working."""

    __slots__ = ("registry", "prefix", "_keys")

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Tuple[str, ...]):
        self.registry = registry
        self.prefix = prefix
        self._keys = tuple(keys)
        for k in self._keys:
            registry.counter(f"{prefix}.{k}")

    def __getitem__(self, k: str) -> int:
        return self.registry.counter(f"{self.prefix}.{k}").value

    def __setitem__(self, k: str, v: int) -> None:
        self.registry.counter(f"{self.prefix}.{k}").value = v

    def get(self, k: str, default=0):
        return self[k] if k in self._keys else default

    def keys(self):
        return list(self._keys)

    def values(self):
        return [self[k] for k in self._keys]

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def __iter__(self):
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, k) -> bool:
        return k in self._keys

    def __eq__(self, other) -> bool:
        return dict(self.items()) == other

    def __repr__(self) -> str:
        return repr(dict(self.items()))


# Every metric name the stack registers, with its one-line meaning. The
# README "Observability" glossary documents each of these; a test greps
# README for every name that shows up in a live run's snapshot AND asserts
# each lives here, so the table cannot rot silently.
GLOSSARY: Dict[str, str] = {
    # -- resolver (BatchDepsResolver.metrics) --------------------------------
    "resolver.dispatches": "device deps dispatches launched",
    "resolver.subjects": "deps subjects resolved through the device path",
    "resolver.ticks": "node ticks that produced any items",
    "resolver.preaccept_s": "host preaccept transition wall seconds",
    "resolver.encode_s": "host CSR/upload-array build wall seconds",
    "resolver.dispatch_s": "kernel launch + readback-enqueue wall seconds",
    "resolver.harvest_stall_s": "wall seconds blocked on async transfers",
    "resolver.decode_s": "host-side result materialization wall seconds",
    "resolver.readback_s": "device->host transfer wall seconds",
    "resolver.materialize_s": "decode minus in-decode readback",
    "resolver.host_hidden_s": "host phase seconds run while a call was in flight",
    "resolver.staged_dispatches": "launches taken off the encode-ahead list",
    "resolver.padded_dispatches": "fused calls topped up to pad_store_tiers",
    "resolver.prefetched": "harvests whose transfer the readiness poll drained",
    "resolver.polls_armed": "readiness polls armed (device_poll_ms)",
    "resolver.stale_harvests": "calls translated across a compaction",
    "resolver.host_fallbacks": "stale calls with no pinned snapshot",
    "resolver.range_fallbacks": "subjects demoted host-side (unencodable ranges)",
    "resolver.finalized_decodes": "groups decoded from the device CSR",
    "resolver.legacy_decodes": "groups through the legacy unpackbits decode",
    "resolver.finalize_fallbacks": "finalize guards tripped mid-flight",
    "resolver.outcap_tier_switches": "finalize out-cap tier ladder moves",
    "resolver.bound_readback_s": "device dep-bound scalar readback wall seconds",
    "resolver.range_subject_device_decodes": "range subjects decoded from the device stab",
    "resolver.shard_merge_s": "sharded finalize launch + fragment-merge wall seconds",
    "resolver.window_shrinks": "adaptive window scale-down adjustments",
    "resolver.window_widens": "adaptive window scale-up adjustments",
    # -- resolver device-plane fault handling (ops/fault_plane.py) -----------
    "resolver.device_faults_injected": "injected device faults consumed by the pipeline",
    "resolver.device_retries": "bounded dispatch retries + watchdog probes spent",
    "resolver.device_watchdog_trips": "harvests declared wedged/late by the watchdog",
    "resolver.checksum_mismatches": "corrupted harvests caught by the finalize checksum lane",
    "resolver.degraded_dispatches": "dispatches answered host-side (give-ups + quarantine reroutes)",
    "resolver.quarantine_entries": "node health transitions into QUARANTINED",
    "resolver.quarantine_exits": "probation ladders completed back to HEALTHY",
    "resolver.device_canaries": "probation canary dispatches double-decoded",
    # -- resolver computed gauges (folded into resolver.snapshot()) ----------
    "resolver.host_hidden_pct": "share of host phase time hidden in the device window",
    "resolver.upload_bytes": "bytes shipped host->device by arena scatters",
    "resolver.upload_bytes_full_equiv": "bytes the whole-row scheme would have shipped",
    "resolver.upload_bytes.full": "arena bytes shipped as all-lane rows",
    "resolver.upload_bytes.keys": "arena bytes shipped as key-lane deltas",
    "resolver.upload_bytes.ts": "arena bytes shipped as timestamp-lane deltas",
    "resolver.upload_bytes.valid": "arena bytes shipped as valid-lane deltas",
    "resolver.upload_bytes.kids": "arena bytes shipped to the key-id mask table",
    "resolver.upload_bytes.range_full": "interval-arena bytes shipped as full rows",
    "resolver.upload_bytes.range_valid": "interval-arena bytes shipped as valid deltas",
    # -- exec plane (ExecPlane.metrics / ExecCoordinator.metrics) ------------
    "exec.dispatches": "execution-frontier kernel dispatches",
    "exec.releases": "commands released by a device frontier",
    "exec.harvest_stall_s": "wall seconds blocked on frontier readbacks",
    "exec.prefetched": "frontier readbacks drained early by the poll",
    "exec.upload_bytes": "wait-graph arena bytes shipped host->device",
    "exec.upload_bytes_full_equiv": "whole-row baseline for the same dirty sets",
    "exec.upload_bytes.full": "wait-graph bytes shipped as all-lane rows",
    "exec.upload_bytes.ts": "wait-graph bytes shipped as exec-ts deltas",
    "exec.upload_bytes.flags": "wait-graph bytes shipped as flag deltas",
    "exec.dropped_frontiers": "stale-generation frontiers discarded after arena growth",
    "exec.readback_bytes": "frontier bytes fetched (compact lanes; bitmask only on fallback)",
    "exec.readback_full_equiv": "what the full packed-bitmask fetch would have cost",
    "exec.compact_fallbacks": "checksum-mismatch degradations to the bitmask decode",
    "exec.compact_overflows": "released counts past out_cap (tier bumps, bitmask serves)",
    "exec_coord.dispatches": "fused per-node frontier dispatches",
    "exec_coord.fused_dispatches": "frontier dispatches that fused >1 store",
    "exec_coord.harvest_stall_s": "wall seconds the coordinator blocked on readbacks",
    "exec_coord.prefetched": "coordinator readbacks drained early by the poll",
    "exec_coord.staged_blocks": "exec harvests staged into fused protocol_tick launches",
    "exec_coord.readback_bytes": "coordinator frontier bytes fetched (compact lanes)",
    "exec_coord.readback_full_equiv": "full-bitmask baseline for the coordinator's harvests",
    "exec_coord.compact_fallbacks": "coordinator checksum degradations to the bitmask decode",
    "exec_coord.compact_overflows": "coordinator released counts past out_cap",
    # -- device coordination plane (CmdPlane.metrics) ------------------------
    "cmd_plane_dispatches": "batched cmd_tick kernel dispatches",
    "cmd_plane_upload_bytes": "cmd-arena lane bytes shipped host->device",
    "cmd_fastpath_device_evals": "protocol ops evaluated on-device",
    "cmd_plane_fallbacks": "inadmissible ops replayed by host handlers",
    "cmd_plane_checksum_mismatches": "cmd harvests rejected by the checksum lane",
    "cmd_plane_compactions": "cmd-arena compaction passes (generation bumps)",
    "cmd_plane_flush_s": "dirty-lane scatter upload wall seconds",
    "cmd_deferred_spans": "PreAccept spans decided by the host twin for the fused tick",
    "cmd_deferred_ops": "protocol ops deferred through the host twin (megakernel mode)",
    "cmd_defer_retired": "host-twinned PreAccept spans folded back through the fused repair stage",
    "recovery_scan_dispatches": "device recovery-scan queries issued by the progress sweep",
    "recovery_scan_candidates": "stalled candidate rows returned by verified device scans",
    "recovery_scan_fallbacks": "recovery scans degraded to the host walk (checksum mismatch)",
    "recovery_scan_overflows": "recovery scans whose candidate count overflowed out_cap",
    "recovery_scan_device_s": "wall seconds inside the device recovery query",
    "recovery_scan_host_s": "wall seconds inside the host-twin recovery walk",
    # -- per-node txn lifecycle (Node.metrics) -------------------------------
    "txn.started": "coordinations started on this node",
    "txn.failed": "coordinations failed (timeout/invalidated)",
    "txn.commit_latency_us": "sim-time coordinate-start -> client-result latency",
    "txn.apply_latency_us": "sim-time coordinate-start -> applied-quorum latency",
    # -- maelstrom runner (Runner.metrics) -----------------------------------
    "maelstrom.txn_ok": "maelstrom txns acknowledged ok",
    "maelstrom.errors": "maelstrom txns answered with an error",
    "maelstrom.reads_checked": "read results checked for prefix consistency",
    # -- serving surface (NodeServer.metrics, serve/server.py) ---------------
    "serve.admission_busy": "client txns answered BUSY by the admission governor",
    "serve.admission_shed": "overload episodes shed into the resolver's adaptive window",
    "serve.queue_depth": "high-water coordinations in flight behind admission",
    "serve.transport_bytes_in": "socket-transport bytes received (frames + headers)",
    "serve.transport_bytes_out": "socket-transport bytes sent (frames + headers)",
    "serve.txn_ok": "client txns committed and acknowledged over the socket surface",
    "serve.txn_error": "client txns answered with a protocol error",
    # -- open-loop load harness (serve/loadgen.py, per-leg registry) ---------
    "loadgen.ok": "txns acknowledged ok within the client timeout",
    "loadgen.busy": "txns shed with an explicit BUSY reply",
    "loadgen.errors": "txns answered with an error reply",
    "loadgen.lost": "txns with unknown outcome (timeout or dead connection)",
    "loadgen.latency_us": "client-observed commit latency per acknowledged txn",
    # -- cluster-tick engine (sim/mesh_burn.ClusterTickEngine.snapshot(),
    #    folded into the burn report's counters) ------------------------------
    "node_lane_dispatches": "merged node-lane device dispatches (key + range) across cluster ticks",
    "nodes_per_dispatch": "mean distinct nodes whose plans rode one merged dispatch",
    "node_pad_fraction": "share of merged subject rows that were node-tier padding",
    "mesh_tick_fallbacks": "plans launched per-node because no merge inputs were recorded",
    "megakernel_dispatches": "cluster ticks launched as one fused protocol_tick program",
    "launches_per_tick": "mean device program launches per cluster tick that dispatched",
    "fastpath_quorum_txns": "distinct txns whose PreAccept lanes met the in-kernel fast-path quorum",
    "sharded_megakernel_fallbacks": "megakernel ticks on a mesh that fell back to the unfused sharded pair",
    "exec_scan_blocks": "exec frontier blocks that rode fused protocol_tick launches",
    "exec_flush_ticks": "exec-only fused flush ticks (a staged harvest with no protocol work due)",
    # -- device message plane (sim/network.DeviceMessageNetwork
    #    .message_plane_snapshot(), folded into the burn report's counters) ---
    "device_messages_delivered": "deliveries whose payload came from the device mailbox (verified)",
    "mailbox_verify_fallbacks": "deliveries where device words mismatched and the host copy won",
    "mailbox_early_deliveries": "deliveries due before their payload rode a fused launch",
    "mailbox_depth_high_water": "max occupied slots in any destination mailbox ring",
    "mailbox_overflow_spills": "messages spilled to the host path (ring full or oversize payload)",
    "mailbox_bytes_staged": "payload bytes packed into device emit lanes",
    "mailbox_partition_epochs": "partition-mask uploads (once per link-topology epoch)",
    "message_plane_batches": "host callbacks that drained the parked-message heap",
    "message_plane_fires": "message deliveries fired by those drains",
    "messages_per_host_callback": "mean deliveries collapsed into one host callback (fires/batches)",
}
