"""The device execution scheduler: batched release of the execute-order DAG.

The host engine tracks, per command, the set of undecided/unapplied deps
gating its execution (WaitingOn; reference local/Command.java:1224) and walks
waiter lists on every dep transition (Commands.NotifyWaitingOn,
local/Commands.java:960). That walk is the hottest protocol loop. This plane
re-expresses the release test as a batched device computation: a per-store
arena holds each live txn's packed dep-adjacency row plus executeAt /
applied / pending / awaits-all lanes, and one `execution_frontier` kernel
call per tick returns the packed set of commands whose gates are all clear.

Modes:
  - primary: the plane is LOAD-BEARING -- the host wait-graph is still
    maintained (it is the differential oracle: every release asserts
    wo.is_done(), so a premature device release trips immediately under
    paranoia), but release scheduling comes exclusively from harvested
    frontiers. notify_listeners suppresses its own maybe_execute scheduling.
  - off (store.exec_plane is None): host walk schedules releases as before.

Determinism: ticks and harvests are scheduler events; dirty-row uploads and
frontier decodes are pure functions of store state at the tick; release
order is ascending row index. The async dispatch/harvest split mirrors
ops/resolver.py's pipeline (enqueue + copy_to_host_async at dispatch; the
blocking read happens `device_latency_ms` of simulated time later).

Port: the planes live on an explicit device (`device=None` is the card,
and raises without one; "cpu" runs the kernels' plain versions). The
device adjacency stays PACKED, int32 [cap, cap/32] in the host shadow's
own bit order, so the dirty-row upload is a plain row scatter (K8,
csrc/exec_scatter.cu) and the frontier reads cap^2/8 bytes (K9,
csrc/exec_frontier.cu). A launch's readback is a `_DevBuf`: a CUDA event
after the launch and non_blocking copies into pinned host memory; on the
CPU the value is ready at once. Under a megakernel cluster tick with
exec fusion (sim/mesh_burn.py), a compact block stages into the engine's
next protocol_tick instead of launching standalone.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from accord_tpu_torch.local.status import Status
from accord_tpu_torch.obs.metrics import (CounterDict, MetricsRegistry, RegCounter,
                                    RegTimer)
from accord_tpu_torch.obs.trace import REC, node_pid, node_ts
from accord_tpu_torch.ops.encoding import TimestampEncoder
from accord_tpu_torch.ops.resolver import _DevBuf, _resolve_device
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.utils.invariants import Invariants

_NEG = np.iinfo(np.int32).min


def _launch_compact(planes, out_cap: int):
    """frontier_compact with its three compacted lanes already on their
    way to the host: (their _DevBuf, the packed bitmask kept on the
    device for the fallback decode)."""
    from accord_tpu_torch.ops.kernels import frontier_compact
    indptr, rows, csum, packed = frontier_compact(planes, out_cap=out_cap)
    lanes = _DevBuf((indptr, rows, csum))
    lanes.copy_async()
    return lanes, packed


class ExecPlane:
    """One per CommandStore (the wait graph is per-store state)."""

    GROW = 2

    # bench/diagnostic counters -- registry-backed descriptors (obs/metrics):
    # legacy attribute reads/writes proxy onto self.metrics unchanged
    dispatches = RegCounter("exec.dispatches")
    releases = RegCounter("exec.releases")
    harvest_stall_s = RegTimer("exec.harvest_stall_s")
    prefetched = RegCounter("exec.prefetched")
    upload_bytes = RegCounter("exec.upload_bytes")
    upload_bytes_full_equiv = RegCounter("exec.upload_bytes_full_equiv")
    # frontiers dropped on the gen mismatch (compaction raced an in-flight
    # readback) -- previously swallowed silently
    dropped_frontiers = RegCounter("exec.dropped_frontiers")
    # compacted-harvest accounting: bytes the harvest actually fetched vs
    # what the full-bitmask readback would have cost for the same dispatch
    # (the upload-accounting pattern, readback side)
    readback_bytes = RegCounter("exec.readback_bytes")
    readback_full_equiv = RegCounter("exec.readback_full_equiv")
    compact_fallbacks = RegCounter("exec.compact_fallbacks")
    compact_overflows = RegCounter("exec.compact_overflows")

    def __init__(self, store, initial_cap: int = 1024,
                 tick_ms: float = 2.0, device_latency_ms: float = 4.0,
                 compact: bool = False, device=None):
        self.metrics = MetricsRegistry()
        self.store = store
        self.device = _resolve_device(device, "ExecPlane")
        self.cap = initial_cap
        self.count = 0
        self.tick_ms = tick_ms
        self.device_latency_ms = device_latency_ms
        # compacted harvests: the dispatch runs frontier_compact and the
        # harvest fetches only (indptr, rows, csum) -- O(released) bytes --
        # with the full bitmask retained on device for the counted
        # checksum-mismatch / overflow fallbacks
        self.compact = bool(compact)
        self._out_tiers = None   # OutCapTiers, built lazily on first pick
        # per-node fused dispatch (ExecCoordinator.register sets this):
        # ticks route to the coordinator, which answers every store's
        # frontier with ONE device call per node tick
        self.coordinator: Optional["ExecCoordinator"] = None
        self.row_of: Dict[TxnId, int] = {}
        self.txn_ids: List[TxnId] = []
        self.encoder: Optional[TimestampEncoder] = None
        # host shadows (authoritative until scattered)
        self.adj = np.zeros((self.cap, self.cap // 32), dtype=np.uint32)
        self.exec_ts = np.full((self.cap, 3), _NEG, dtype=np.int32)
        self.applied = np.zeros(self.cap, dtype=bool)
        self.pending = np.zeros(self.cap, dtype=bool)
        self.awaits_all = np.zeros(self.cap, dtype=bool)
        # per-field dirty sets (same scheme as the resolver arenas): `full`
        # rows re-ship every lane (new rows, stable ingests, edge rewrites);
        # ts/flags rows ship just that lane group via the shared flush_lanes
        # helper (one K4 launch for the three lanes) -- an executeAt bump no
        # longer re-uploads a cap/8-byte adjacency row
        self._dirty_full: set = set()
        self._dirty_ts: set = set()
        self._dirty_flags: set = set()
        self._device = None
        self._ticking = False
        self._gen = 0   # bumped by compaction: retires in-flight frontiers
                        # whose row indices refer to the old mapping
        self._compacting = False
        self._released: set = set()   # rows released (guard double release)
        # in-order queue of in-flight frontier readbacks: [frontier,
        # host copy or None, gen]; each dispatch schedules one harvest,
        # which pops the head (mirrors ops/resolver.py's pipeline)
        self._inflight: deque = deque()
        self._poll_armed = False
        # field-granular accounting, mirroring the resolver arenas:
        # upload_bytes == sum of the by-field buckets; full_equiv is what
        # the retired whole-row scheme would have shipped for the same
        # dirty sets (the baseline proving the granular deltas' win)
        self.upload_bytes_by_field = CounterDict(
            self.metrics, "exec.upload_bytes", ("full", "ts", "flags"))

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    # -- row management ------------------------------------------------------
    def _row(self, txn_id: TxnId) -> int:
        row = self.row_of.get(txn_id)
        if row is not None:
            return row
        if self.encoder is None:
            self.encoder = TimestampEncoder(0, txn_id.hlc)
        if self.count == self.cap:
            self._grow()
        row = self.count
        self.count += 1
        self.row_of[txn_id] = row
        self.txn_ids.append(txn_id)
        self._dirty_full.add(row)
        return row

    def _ensure_capacity(self, n: int) -> None:
        """Make room for `n` new rows BEFORE an ingestion allocates them:
        compaction remaps (and may drop) existing rows, so it must never run
        between an ingestion's allocations and its writes. Prefers
        reclaiming dead history (rows stay live only while pending or
        referenced by a pending wait set) over growing."""
        if self.cap - self.count >= n:
            return
        if self._compacting or not self._compact():
            while self.cap - self.count < n:
                self._grow()

    def _live_set(self) -> List[TxnId]:
        """Pending commands plus every dep their wait sets still reference
        (everything else is settled history that can never gate again)."""
        store = self.store
        live: List[TxnId] = []
        seen = set()
        for row in np.nonzero(self.pending[:self.count])[0].tolist():
            tid = self.txn_ids[row]
            cmd = store.command_if_present(tid)
            if cmd is None:
                continue
            if tid not in seen:
                seen.add(tid)
                live.append(tid)
            wo = cmd.waiting_on
            if wo is not None:
                for dep in wo.commit | wo.apply:
                    if dep not in seen:
                        seen.add(dep)
                        live.append(dep)
        return live

    def _compact(self) -> bool:
        """Rebuild the arena keeping only live rows. Returns False when
        compaction would not reclaim at least half the capacity -- the
        caller grows instead. Rebuilding from the host wait-graph (the
        oracle) is exact: edges, lanes and flags are re-derived from
        current command state."""
        self._compacting = True
        live = self._live_set()
        if len(live) > self.cap // 2:
            self._compacting = False
            return False
        self._rebuild(live)
        self._compacting = False
        return True

    def _ensure_window(self, ts) -> None:
        """Guard before encode(): executeAt hlc drifts past the encoder's
        int32 window (~2^31 us, ~35 simulated minutes) on long-running
        stores; re-base via a forced rebuild rather than raising inside
        on_stable/on_status (the resolver guards this case the same way)."""
        if ts is None or self.encoder is None or self.encoder.in_window(ts):
            return
        if self._compacting:
            return  # the in-progress rebuild already re-bases
        self._compacting = True
        self._rebuild(self._live_set(), extra_base=ts)
        self._compacting = False

    def _encode(self, ts):
        """All hook-path encodes go through here: a compaction triggered by
        _ensure_capacity can re-base the encoder AFTER _ensure_window ran
        (the incoming command is not yet in the live set), so the window is
        re-verified at the encode itself. A live-set spread exceeding the
        int32 window (~35 simulated minutes between the oldest wedged
        executeAt and this one) cannot be encoded at any base: fail with a
        diagnostic rather than an opaque ValueError."""
        Invariants.check_state(
            self.encoder is not None and self.encoder.in_window(ts),
            "exec plane live window exceeds encoder range at %s "
            "(oldest live executeAt is >2^31us behind; a dep is wedged)", ts)
        return self.encoder.encode([ts])[0]

    def _rebuild(self, live: List[TxnId], extra_base=None) -> None:
        """Reset and re-ingest `live`; always re-bases the encoder to the
        minimum live executeAt (encodings are base-relative and the live
        window drifts forward over the store's lifetime)."""
        store = self.store
        base = extra_base
        for tid in live:
            cmd = store.command_if_present(tid)
            ts = cmd.execute_at if cmd is not None else None
            for cand in (ts, tid.as_timestamp()):
                if cand is not None and (base is None or cand < base):
                    base = cand
        if base is not None:
            self.encoder = TimestampEncoder(base.epoch, base.hlc)
        self.count = 0
        self.row_of = {}
        self.txn_ids = []
        self.adj[:] = 0
        self.exec_ts[:] = _NEG
        self.applied[:] = False
        self.pending[:] = False
        self.awaits_all[:] = False
        self._released = set()
        self._device = None
        self._dirty_full = set()
        self._dirty_ts = set()
        self._dirty_flags = set()
        self._gen += 1
        for tid in live:
            row = self._row(tid)
            cmd = store.command_if_present(tid)
            if cmd is None or cmd.has_been(Status.APPLIED) \
                    or cmd.status.is_terminal:
                self.applied[row] = True
                continue
            if cmd.known_execute_at and cmd.execute_at is not None:
                self.exec_ts[row] = self._encode(cmd.execute_at)
        for tid in live:
            cmd = store.command_if_present(tid)
            if cmd is not None and cmd.has_been(Status.STABLE) \
                    and not cmd.status.is_terminal \
                    and not cmd.has_been(Status.APPLIED):
                self.on_stable(cmd)

    def _grow(self) -> None:
        old_cap = self.cap
        self.cap *= self.GROW
        self.adj = np.pad(self.adj, ((0, self.cap - old_cap),
                                     (0, (self.cap - old_cap) // 32)))
        self.exec_ts = np.pad(self.exec_ts, ((0, self.cap - old_cap), (0, 0)),
                              constant_values=_NEG)
        self.applied = np.pad(self.applied, (0, self.cap - old_cap))
        self.pending = np.pad(self.pending, (0, self.cap - old_cap))
        self.awaits_all = np.pad(self.awaits_all, (0, self.cap - old_cap))
        # column width changed: the device copy must be rebuilt wholesale
        self._device = None

    # -- hooks from the engine (commands.py) ---------------------------------
    def on_stable(self, cmd) -> None:
        """A command became STABLE: ingest its wait edges and pending flag.
        Called after _init_waiting_on built the (floor-elided) edge set.

        All rows are allocated BEFORE any write: _row can trigger a
        compaction that remaps every index, so an index held across an
        allocation would be stale."""
        self._ensure_window(cmd.execute_at)
        wo = cmd.waiting_on
        dep_ids = tuple(wo.commit | wo.apply) if wo is not None else ()
        self._ensure_capacity(1 + len(dep_ids))
        self._row(cmd.txn_id)
        for dep_id in dep_ids:
            self._row(dep_id)
        row = self.row_of[cmd.txn_id]
        self.awaits_all[row] = cmd.txn_id.kind.awaits_only_deps
        if cmd.execute_at is not None:
            self.exec_ts[row] = self._encode(cmd.execute_at)
        self.adj[row] = 0
        for dep_id in dep_ids:
            d = self.row_of[dep_id]
            self.adj[row, d >> 5] |= np.uint32(1 << (d & 31))
        self.pending[row] = True
        self._released.discard(row)
        self._dirty_full.add(row)
        self._schedule_tick()

    def on_status(self, cmd) -> None:
        """A command's status advanced (it may gate others): refresh its
        dep-side lanes. Delta-aware: a hook that changes no lane (repeated
        status bumps between ticks are common) dirties nothing, so the next
        dispatch uploads only genuinely-changed rows."""
        if cmd.known_execute_at:
            self._ensure_window(cmd.execute_at)
        row = self.row_of.get(cmd.txn_id)
        if row is None:
            return
        changed = False
        if cmd.known_execute_at and cmd.execute_at is not None:
            enc = self._encode(cmd.execute_at)
            if not np.array_equal(self.exec_ts[row], enc):
                self.exec_ts[row] = enc
                self._dirty_ts.add(row)
                changed = True
        if cmd.has_been(Status.APPLIED) or cmd.status.is_terminal:
            if not self.applied[row] or self.pending[row]:
                self.applied[row] = True
                self.pending[row] = False
                self._dirty_flags.add(row)
                changed = True
        if changed:
            self._schedule_tick()

    def on_edges_changed(self, cmd) -> None:
        """Floor/ownership elision rewrote the wait set: resync the row.
        (Rows allocated before writes -- see on_stable.)"""
        if cmd.txn_id not in self.row_of:
            return
        wo = cmd.waiting_on
        dep_ids = ()
        if wo is not None and not wo.is_done():
            dep_ids = tuple(wo.commit | wo.apply)
            self._ensure_capacity(len(dep_ids))
            for dep_id in dep_ids:
                self._row(dep_id)
        row = self.row_of.get(cmd.txn_id)
        if row is None:
            return  # compaction dropped it (no longer pending/referenced)
        new_adj = np.zeros_like(self.adj[row])
        for dep_id in dep_ids:
            d = self.row_of[dep_id]
            new_adj[d >> 5] |= np.uint32(1 << (d & 31))
        if np.array_equal(new_adj, self.adj[row]):
            return  # elision rewrote to the same edges: nothing to upload
        self.adj[row] = new_adj
        self._dirty_full.add(row)
        self._schedule_tick()

    def on_erased(self, txn_id: TxnId) -> None:
        row = self.row_of.get(txn_id)
        if row is None or (self.applied[row] and not self.pending[row]):
            return
        self.applied[row] = True   # an erased record gates nothing
        self.pending[row] = False
        self._dirty_flags.add(row)
        self._schedule_tick()

    # -- the tick/harvest pipeline -------------------------------------------
    def _schedule_tick(self) -> None:
        if self.coordinator is not None:
            self.coordinator.schedule()
            return
        if self._ticking:
            return
        self._ticking = True
        self.store.node.scheduler.once(self.tick_ms, self._tick)

    def _needs_dispatch(self) -> bool:
        """The tick's launch gate: something pending AND either dirty state
        to sync or no device copy yet (an unchanged arena's frontier was
        already harvested; the next on_* hook re-arms the tick)."""
        if not self.pending.any():
            return False
        return bool(self._dirty_full or self._dirty_ts or self._dirty_flags) \
            or self._device is None

    def _tick(self) -> None:
        self._ticking = False
        if not self._needs_dispatch():
            return
        self._dispatch()   # appends its own in-flight entry
        self.store.node.scheduler.once(self.device_latency_ms, self._harvest)
        self._ensure_poll()

    def _pick_out_cap(self) -> int:
        """Pin the compaction tier for this dispatch: hysteresis over the
        device-observed release counts, seeded with the pending-row count
        (an exact upper bound) while cold."""
        if self._out_tiers is None:
            from accord_tpu_torch.ops.kernels import FRONTIER_OUT_TIERS
            from accord_tpu_torch.ops.tiers import OutCapTiers
            self._out_tiers = OutCapTiers(FRONTIER_OUT_TIERS,
                                          FRONTIER_OUT_TIERS[-1] * 2)
        pend = int(self.pending.sum())
        est = self._out_tiers.estimate(1)
        return self._out_tiers.pick(est if est is not None else max(1, pend))

    def _observe_bound(self, total: int) -> None:
        if self._out_tiers is not None:
            self._out_tiers.observe(total, 1)

    def _ensure_poll(self) -> None:
        """Between dispatch and harvest, a cheap deterministic poll drains
        finished async readbacks via the non-blocking ready() probe; it
        only fills the in-flight entries' host-copy slot (invisible to
        simulated state), so determinism is untouched -- see
        sim/scheduler.py poll()."""
        scheduler = self.store.node.scheduler
        poll = getattr(scheduler, "poll", None)
        # opt-in via node.device_poll_ms, as in resolver._ensure_poll
        interval = getattr(self.store.node, "device_poll_ms", None)
        if poll is None or interval is None or self._poll_armed:
            return
        self._poll_armed = True
        q = self._inflight

        def prefetch() -> bool:
            _poll_prefetch(q)
            if q:
                return True
            self._poll_armed = False
            return False

        poll(interval, prefetch)

    def _full_row_bytes(self, m: int) -> int:
        """Bytes one whole-row exec_scatter chunk of tier m ships: row index
        + packed adjacency + exec_ts + applied/pending/awaits flags."""
        return m * (4 + self.cap // 8 + 12 + 3)

    def _dispatch(self) -> None:
        """Solo (uncoordinated) launch: sync dirty rows, fire the frontier
        kernel (compacted or legacy bitmask), enqueue its async readback."""
        from accord_tpu_torch.ops.kernels import execution_frontier
        devs = self._sync_device()
        if self.compact:
            out_cap = self._pick_out_cap()
            res = _launch_compact((tuple(devs),), out_cap)
            self._inflight.append([res, None, self._gen, out_cap])
        else:
            out = _DevBuf(execution_frontier(*devs))
            out.copy_async()
            self._inflight.append([out, None, self._gen])
        self.dispatches += 1
        if REC.enabled:
            node = self.store.node
            REC.instant(node_pid(node), "exec", "frontier_dispatch",
                        node_ts(node), args={"rows": self.count,
                                             "compact": self.compact})

    def _sync_device(self):
        """Flush the dirty sets into the device arena and return its lane
        tuple (adj, exec_ts, applied, pending, awaits_all) -- the shared
        front half of the solo dispatch and the coordinator's fused one."""
        from accord_tpu_torch.ops.deltas import (LANE_ROW_TIERS, flush_lanes,
                                                 lane_row_tier)
        from accord_tpu_torch.ops.kernels import exec_scatter, upload
        dev = self.device
        if self._device is None:
            # the device adjacency stays PACKED (i32[cap, cap/32], the host
            # shadow's words); build it by scattering every populated row
            self._device = (
                torch.zeros((self.cap, self.cap // 32), dtype=torch.int32,
                            device=dev),
                torch.full((self.cap, 3), _NEG, dtype=torch.int32,
                           device=dev),
                torch.zeros(self.cap, dtype=torch.bool, device=dev),
                torch.zeros(self.cap, dtype=torch.bool, device=dev),
                torch.zeros(self.cap, dtype=torch.bool, device=dev))
            self._dirty_full = set(range(self.count))
            self._dirty_ts.clear()
            self._dirty_flags.clear()
        if self._dirty_full:
            # the full upload carries every lane: granular marks on the
            # same rows are satisfied by it
            self._dirty_ts -= self._dirty_full
            self._dirty_flags -= self._dirty_full
            full = sorted(self._dirty_full)
            step = LANE_ROW_TIERS[-1]
            for lo in range(0, len(full), step):
                chunk = full[lo:lo + step]
                # pad to the shared 8/64 row tiers by repeating the first
                # row (duplicate scatter indexes write identical data), so
                # dirty-count drift never mints a new compiled shape
                m = lane_row_tier(len(chunk))
                rows = np.full(m, chunk[0], dtype=np.int32)
                rows[:len(chunk)] = chunk
                # fancy-indexed selections below COPY, so the async
                # computation never aliases the live host shadows (zero-copy
                # aliasing on the CPU backend raced host mutations and broke
                # determinism)
                uploads = (rows, self.adj[rows].view(np.int32),
                           self.exec_ts[rows],
                           self.applied[rows], self.pending[rows],
                           self.awaits_all[rows])
                nb = sum(u.nbytes for u in uploads)
                self.upload_bytes += nb
                self.upload_bytes_by_field["full"] += nb
                self.upload_bytes_full_equiv += nb
                self._device = exec_scatter(
                    *self._device, *(upload(u, dev) for u in uploads))
            self._dirty_full.clear()
        if self._dirty_ts or self._dirty_flags:
            # all-lanes baseline FIRST, over the union of granular rows
            # chunked exactly like the whole-row scheme would have
            union = sorted(self._dirty_ts | self._dirty_flags)
            step = LANE_ROW_TIERS[-1]
            for lo in range(0, len(union), step):
                self.upload_bytes_full_equiv += self._full_row_bytes(
                    lane_row_tier(len(union[lo:lo + step])))
            d = list(self._device)

            def acct(field):
                def on_chunk(nbytes: int, _m: int) -> None:
                    self.upload_bytes += nbytes
                    self.upload_bytes_by_field[field] += nbytes
                return on_chunk

            flags = sorted(self._dirty_flags)
            d[1], d[2], d[3] = flush_lanes((
                (d[1], sorted(self._dirty_ts), self.exec_ts, acct("ts")),
                (d[2], flags, self.applied, acct("flags")),
                (d[3], flags, self.pending, acct("flags"))))
            self._dirty_ts.clear()
            self._dirty_flags.clear()
            self._device = tuple(d)
        return self._device

    def _harvest(self) -> None:
        import time as _time
        if not self._inflight:
            return  # defensive: every dispatch schedules exactly one harvest
        entry = self._inflight.popleft()
        if len(entry) == 4:   # compacted dispatch
            res, host, gen, out_cap = entry
            if host is None:
                t0 = _time.perf_counter()
                host = _fetch_compact(res)
                self.harvest_stall_s += _time.perf_counter() - t0
            else:
                self.prefetched += 1
            w = int(res[-1].shape[0])
            _consume_compact(self, res, host, [(self, (0, w), gen)], out_cap)
            return
        frontier, packed, gen = entry
        if packed is None:
            t0 = _time.perf_counter()
            packed = frontier.read()
            self.harvest_stall_s += _time.perf_counter() - t0
        else:
            self.prefetched += 1
        self.readback_bytes += packed.nbytes
        self.readback_full_equiv += packed.nbytes
        self._apply_frontier(packed, gen)

    def _drop_frontier(self, gen: int, rows: int) -> None:
        """The gen-mismatch drop path: compaction remapped rows while this
        frontier was in flight; its indices address the old arena -- drop
        it (the rebuild re-ingested every pending row, so a fresh tick
        re-covers them). Counted + recorded so compaction races are
        visible instead of silently swallowed."""
        self.dropped_frontiers += 1
        if REC.enabled:
            node = self.store.node
            REC.instant(node_pid(node), "exec", "dropped_frontier",
                        node_ts(node),
                        args={"gen": gen, "live_gen": self._gen,
                              "rows": rows})
        self._schedule_tick()

    def _apply_frontier(self, packed: np.ndarray, gen: int) -> None:
        """Legacy bitmask decode (the back half of the harvest, shared with
        the coordinator, which hands each plane its word span of the fused
        readback): unpack + nonzero walk, then the shared release loop."""
        if gen != self._gen:
            self._drop_frontier(gen, -1)
            return
        rows = np.nonzero(
            np.unpackbits(packed.view(np.uint8), bitorder="little"))[0]
        self._apply_rows(rows.tolist(), gen)

    def _apply_rows(self, rows, gen: int) -> None:
        """Release every listed arena row against current host state.
        `rows` arrive ascending -- the exact order the bitmask decode
        produced -- so compacted and legacy harvests release identically."""
        from accord_tpu_torch.local import commands as _commands
        if gen != self._gen:
            self._drop_frontier(gen, len(rows))
            return
        store = self.store
        for row in rows:
            if row >= self.count or row in self._released \
                    or not self.pending[row]:
                continue
            cmd = store.command_if_present(self.txn_ids[row])
            if cmd is None:
                continue
            # differential oracle: the host wait-graph must agree that this
            # command is releasable -- a premature device release is a bug
            Invariants.check_state(
                cmd.waiting_on is None or cmd.waiting_on.is_done(),
                "device frontier released %s before host WaitingOn drained: %s",
                cmd.txn_id, cmd.waiting_on)
            self._released.add(row)
            self.releases += 1
            _commands.maybe_execute(store, cmd)
        if self.pending.any():
            self._schedule_tick()


class ExecTicket:
    """A staged exec block awaiting the engine's next fused protocol_tick.
    The coordinator holds one in place of a launched frontier_compact
    result; the cluster engine fulfills `.result` with the block's
    (compacted lanes' _DevBuf, packed) output at its next megakernel
    launch, or at an exec-only flush tick if the coordinator's harvest
    comes due first. Purely a host-side rendezvous -- the device
    computation is the same frontier_compact either way, so fused and
    standalone harvests release bit-identically."""

    __slots__ = ("planes", "out_cap", "result")

    def __init__(self, planes, out_cap: int):
        self.planes = planes
        self.out_cap = out_cap
        self.result = None


def _fetch_compact(res):
    """Fetch a compacted result's (indptr, rows, csum) host copies; the
    retained packed bitmask (res[-1]) stays on device."""
    return res[0].read()


def _poll_prefetch(q) -> None:
    """Drain finished async readbacks into the in-flight entries' host-copy
    slots via the non-blocking ready() probe (shared by the plane and
    coordinator poll loops). Compact entries fetch only their three
    compacted lanes; engine tickets wait until the fused launch fulfilled
    them."""
    for entry in q:
        if entry[1] is not None:
            continue
        obj = entry[0]
        if isinstance(obj, ExecTicket):
            obj = obj.result
            if obj is None:
                break   # awaiting the engine's next fused launch
        if isinstance(obj, tuple):
            if not obj[0].ready():
                break   # single device stream: later calls finish later
            entry[1] = _fetch_compact(obj)
            continue
        if not obj.ready():
            break  # single device stream: later calls finish later
        entry[1] = obj.read()


def _consume_compact(owner, res, host, entries, out_cap: int) -> None:
    """Decode one compacted frontier readback and release per plane.
    `owner` carries the readback counters and out-cap policy (the plane
    itself on the solo path, the coordinator on the fused one); `entries`
    is [(plane, (w_lo, w_hi), gen)] with per-plane word spans into the
    retained packed bitmask (res[-1]), one compaction segment per plane in
    order."""
    from accord_tpu_torch.ops.kernels import frontier_checksum_host
    indptr, rows, csum = host
    total = int(indptr[-1])
    full_w = sum(hi - lo for _p, (lo, hi), _g in entries)
    owner.readback_full_equiv += full_w * 4
    owner.readback_bytes += indptr.nbytes + rows.nbytes + 4
    # the device word rides as an int32 bit pattern
    bad = frontier_checksum_host(indptr, rows) != int(csum) & 0xFFFFFFFF
    if bad or total > out_cap:
        # a corrupt readback, or more releases than the pinned tier holds
        # (indptr is exact either way: the overflow bumps straight to a
        # fitting rung) -- fall back to the legacy decode of the retained
        # device bitmask. The release set is identical, so chaos and
        # --reconcile stay bit-identical through the degradation.
        if bad:
            owner.compact_fallbacks += 1
        else:
            owner.compact_overflows += 1
            owner._observe_bound(total)
            if owner._out_tiers is not None:
                owner._out_tiers.overflowed()
        packed = res[-1].cpu().numpy()   # blocking: the fallback only
        owner.readback_bytes += packed.nbytes
        for plane, (lo, hi), gen in entries:
            plane._apply_frontier(packed[lo:hi], gen)
        return
    owner._observe_bound(total)
    for i, (plane, (lo, hi), gen) in enumerate(entries):
        seg = rows[indptr[i]:indptr[i + 1]] - 32 * lo
        plane._apply_rows(seg.tolist(), gen)


class ExecCoordinator:
    """Per-NODE fusion of the exec planes' frontier calls, mirroring the
    resolver's cross-store fused dispatch: each node tick collects every
    registered plane with work, syncs their dirty rows, and answers all of
    them with ONE device call -- the plain kernel for a single participant
    (byte-identical to the solo path), `fused_execution_frontier` with
    per-store word spans otherwise. Cuts per-tick launch count on
    many-store nodes from stores-with-work to one."""

    # registry-backed counters (see ExecPlane's descriptor block)
    dispatches = RegCounter("exec_coord.dispatches")
    fused_dispatches = RegCounter("exec_coord.fused_dispatches")
    harvest_stall_s = RegTimer("exec_coord.harvest_stall_s")
    prefetched = RegCounter("exec_coord.prefetched")
    staged_blocks = RegCounter("exec_coord.staged_blocks")
    readback_bytes = RegCounter("exec_coord.readback_bytes")
    readback_full_equiv = RegCounter("exec_coord.readback_full_equiv")
    compact_fallbacks = RegCounter("exec_coord.compact_fallbacks")
    compact_overflows = RegCounter("exec_coord.compact_overflows")

    def __init__(self, node, tick_ms: float = 2.0,
                 device_latency_ms: float = 4.0, compact: bool = False,
                 device=None):
        self.metrics = MetricsRegistry()
        self.node = node
        self.device = _resolve_device(device, "ExecCoordinator")
        self.tick_ms = tick_ms
        self.device_latency_ms = device_latency_ms
        self.compact = bool(compact)
        self._out_tiers = None
        self.planes: List[ExecPlane] = []
        self._ticking = False
        # [fused frontier | compact result | ExecTicket, host copy or None,
        #  [(plane, (lo, hi), gen)], out_cap (compact entries only)]
        self._inflight: deque = deque()
        self._poll_armed = False

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

    def register(self, plane: ExecPlane) -> None:
        if plane.device != self.device:
            raise ValueError(f"ExecCoordinator on {self.device} cannot fuse "
                             f"a plane on {plane.device}")
        plane.coordinator = self
        self.planes.append(plane)

    def _engine(self):
        """The cluster tick engine, when this node rides a megakernel burn
        with exec fusion enabled: the compact block then STAGES into the
        engine's next protocol_tick instead of launching standalone, so
        exec traffic shares the cluster tick's single device call. Resolved
        lazily per tick -- the engine adopts resolvers after node wiring."""
        if not self.compact:
            return None
        res = getattr(self.node, "_deps_resolver", None)
        eng = getattr(res, "tick_driver", None) if res is not None else None
        return eng if getattr(eng, "exec_in_megakernel", False) else None

    def _observe_bound(self, total: int) -> None:
        if self._out_tiers is not None:
            self._out_tiers.observe(total, 1)

    def _pick_out_cap(self, parts) -> int:
        if self._out_tiers is None:
            from accord_tpu_torch.ops.kernels import FRONTIER_OUT_TIERS
            from accord_tpu_torch.ops.tiers import OutCapTiers
            self._out_tiers = OutCapTiers(FRONTIER_OUT_TIERS,
                                          FRONTIER_OUT_TIERS[-1] * 2)
        pend = sum(int(p.pending.sum()) for p in parts)
        est = self._out_tiers.estimate(1)
        return self._out_tiers.pick(est if est is not None else max(1, pend))

    def schedule(self) -> None:
        if self._ticking:
            return
        self._ticking = True
        self.node.scheduler.once(self.tick_ms, self._tick)

    def _tick(self) -> None:
        from accord_tpu_torch.ops.kernels import (execution_frontier,
                                                  fused_execution_frontier)
        self._ticking = False
        parts = [p for p in self.planes if p._needs_dispatch()]
        if not parts:
            return
        devs = [p._sync_device() for p in parts]
        spans, off = [], 0
        for p in parts:
            spans.append((off, off + p.cap // 32))
            off += p.cap // 32
        if self.compact:
            out_cap = self._pick_out_cap(parts)
            planes_in = tuple(tuple(d) for d in devs)
            engine = self._engine()
            if engine is not None:
                # ride the cluster tick's single launch: the engine folds
                # this block into its next fused protocol_tick (or an
                # exec-only flush tick if our harvest comes due first)
                out = engine.stage_exec(planes_in, out_cap, self.node)
                self.staged_blocks += 1
            else:
                out = _launch_compact(planes_in, out_cap)
            entry = [out, None,
                     [(p, s, p._gen) for p, s in zip(parts, spans)],
                     out_cap]
        else:
            if len(parts) == 1:
                out = _DevBuf(execution_frontier(*devs[0]))
            else:
                out = _DevBuf(fused_execution_frontier(tuple(devs)))
            out.copy_async()
            entry = [out, None,
                     [(p, s, p._gen) for p, s in zip(parts, spans)]]
        if len(parts) > 1:
            self.fused_dispatches += 1
        self.dispatches += 1
        for p in parts:
            p.dispatches += 1
        if REC.enabled:
            REC.instant(node_pid(self.node), "exec", "frontier_dispatch",
                        node_ts(self.node),
                        args={"stores": len(parts),
                              "fused": len(parts) > 1,
                              "compact": self.compact})
        self._inflight.append(entry)
        self.node.scheduler.once(self.device_latency_ms, self._harvest)
        self._ensure_poll()

    def _ensure_poll(self) -> None:
        scheduler = self.node.scheduler
        poll = getattr(scheduler, "poll", None)
        interval = getattr(self.node, "device_poll_ms", None)
        if poll is None or interval is None or self._poll_armed:
            return
        self._poll_armed = True
        q = self._inflight

        def prefetch() -> bool:
            _poll_prefetch(q)
            if q:
                return True
            self._poll_armed = False
            return False

        poll(interval, prefetch)

    def _harvest(self) -> None:
        import time as _time
        if not self._inflight:
            return  # defensive: every dispatch schedules exactly one harvest
        entry = self._inflight.popleft()
        if len(entry) == 4:   # compacted dispatch (standalone or staged)
            obj, host, entries, out_cap = entry
            res = obj
            if isinstance(obj, ExecTicket):
                if obj.result is None:
                    # no cluster tick fired between our dispatch and this
                    # harvest: the engine flushes the queued blocks as one
                    # exec-only fused tick (its launch ledger keeps
                    # launches_per_tick == 1.0 by construction)
                    self._engine_flush()
                res = obj.result
                if res is None:
                    # defensive: the engine vanished mid-flight -- run the
                    # identical block standalone (same body, same result)
                    res = obj.result = _launch_compact(obj.planes, out_cap)
            if host is None:
                t0 = _time.perf_counter()
                host = _fetch_compact(res)
                self.harvest_stall_s += _time.perf_counter() - t0
            else:
                self.prefetched += 1
            _consume_compact(self, res, host, entries, out_cap)
            return
        frontier, packed, entries = entry
        if packed is None:
            t0 = _time.perf_counter()
            packed = frontier.read()
            self.harvest_stall_s += _time.perf_counter() - t0
        else:
            self.prefetched += 1
        self.readback_bytes += packed.nbytes
        self.readback_full_equiv += packed.nbytes
        for plane, (lo, hi), gen in entries:
            plane._apply_frontier(packed[lo:hi], gen)

    def _engine_flush(self) -> None:
        res = getattr(self.node, "_deps_resolver", None)
        eng = getattr(res, "tick_driver", None) if res is not None else None
        if eng is not None:
            eng.flush_exec()
