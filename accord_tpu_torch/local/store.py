"""CommandStore: one single-threaded shard engine within a node.

Role-equivalent to the reference's CommandStore/SafeCommandStore
(local/CommandStore.java:82, SafeCommandStore.java:58) and the in-memory
reference implementation (impl/InMemoryCommandStore.java:92). Owns a slice of
the node's ranges and every per-txn Command plus per-key conflict registry for
that slice. All access is funneled through execute()/submit() so the
simulator can inject asynchronous load delays exactly like the reference's
DelayedCommandStores.

The deps-calculation entry points (preaccept_timestamp, calculate_deps) are
THE hot path (reference: PreAccept.calculatePartialDeps,
messages/PreAccept.java:245); they delegate to a pluggable DepsResolver so the
TPU batched implementation (accord_tpu_torch.ops) can replace the host scan.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, TYPE_CHECKING

from accord_tpu_torch.local.cfk import CfkStatus, CommandsForKey
from accord_tpu_torch.local.command import Command
from accord_tpu_torch.local.status import Status
from accord_tpu_torch.primitives.deps import Deps, KeyDepsBuilder, RangeDepsBuilder
from accord_tpu_torch.primitives.keyspace import Key, Keys, Range, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TxnKind
from accord_tpu_torch.utils.async_ import AsyncResult, success
from accord_tpu_torch.utils.invariants import Invariants
from accord_tpu_torch.utils.range_map import ReducingRangeMap

if TYPE_CHECKING:
    from accord_tpu_torch.local.node import Node


class CommandStore:
    def __init__(self, store_id: int, node: "Node", ranges: Ranges,
                 progress_log_factory: Optional[Callable] = None,
                 deps_resolver=None):
        self.store_id = store_id
        self.node = node
        # `ranges` is this store's FIXED slice of the global key domain: the
        # intra-node partition is stable across topology changes, so per-key
        # state never migrates between stores (a deliberate re-design of the
        # reference's dynamic RangesForEpoch splits, local/CommandStores.java:143;
        # stable slices keep the TPU active-set buffers append-only).
        self.slice_ranges = ranges
        # what the node actually owns of this slice, per epoch (reference:
        # CommandStores.RangesForEpoch, local/CommandStores.java:143-335)
        self._owned_by_epoch: Dict[int, Ranges] = {}
        self._owned_union: Ranges = Ranges.EMPTY
        # ranges this store may serve reads for (gated by bootstrap;
        # reference: CommandStore.safeToRead)
        self.safe_to_read: Ranges = Ranges.EMPTY
        self.commands: Dict[TxnId, Command] = {}
        # txn ids with live waiting_on edges (maintained by commands.py):
        # the progress engine's stuck-waiter sweep scans only these
        self.live_waiters: set = set()
        self.cfks: Dict[Key, CommandsForKey] = {}
        self.range_txns: Dict[TxnId, Ranges] = {}  # witnessed range-domain txns
        # interval index over range_txns (reference: SearchableRangeList /
        # CINTIA, utils/SearchableRangeList.java) -- stab/overlap queries
        # instead of linear scans
        from accord_tpu_torch.utils.interval_index import IntervalIndex
        self.range_index = IntervalIndex()
        # monotone counter of commit-cover events (transitive-dependency
        # elision): stamps cfk cover entries so the async device decode can
        # scope elision to covers its kernel snapshot saw
        self.cover_seq = 0
        # max witnessed conflict per exact key (hot path: O(1) updates);
        # range-domain txns land in the range map (rare, merged on query)
        self.max_conflicts_by_key: Dict[Key, Timestamp] = {}
        self.max_conflicts: ReducingRangeMap = ReducingRangeMap.EMPTY
        self.progress_log = (progress_log_factory(self) if progress_log_factory
                             else _NoopProgressLog())
        self.deps_resolver = deps_resolver  # None -> host scan below
        self.exec_plane = None              # optional device exec scheduler
        self.cmd_plane = None               # optional device command arena
        # micro-batch coalescing window for the async device path (resolver
        # owns the per-NODE tick, which fuses EVERY store's pending items
        # into one cross-store dispatch; see ops/resolver.BatchDepsResolver):
        # 0.0 = coalesce same-scheduler-turn arrivals; None = inline (no
        # deferral -- bit-identical timing with the host path, used by the
        # differential tests)
        self.batch_window_ms: Optional[float] = getattr(
            node, "deps_batch_window_ms", 0.0)
        # ExclusiveSyncPoint floor machinery (reference:
        # local/CommandStore.java:301-317 + RedundantBefore.java:49):
        #   reject_before  -- set at ESP *preaccept*: any later-arriving txn
        #     with id below the floor gets a REJECTED witness timestamp, so
        #     its coordinator invalidates it instead of committing behind the
        #     sync point.
        #   redundant_before -- set at ESP *local apply*: every conflicting
        #     txn below it has applied locally; deps below the floor are
        #     elided and (once shard-durable) state below it may be truncated.
        self.reject_before: ReducingRangeMap = ReducingRangeMap.EMPTY
        self.redundant_before: ReducingRangeMap = ReducingRangeMap.EMPTY
        # bootstrap floor (reference: CommandStore.bootstrapBeganAt +
        # RedundantBefore.bootstrappedAt): deps below it within bootstrapped
        # ranges were covered by the fetched snapshot -- never waited on
        self.bootstrapped_at: ReducingRangeMap = ReducingRangeMap.EMPTY
        # ranges where this store's data has an unfilled gap: a bootstrap
        # floor was set but its snapshot has not arrived (or the bootstrap
        # was aborted by a later removal). The store must not serve fetches
        # for them -- dep elision + a missing snapshot would hand a fetcher
        # stale data. Cleared only when a bootstrap's snapshot merges.
        self.data_gaps: Ranges = Ranges.EMPTY
        # subset of data_gaps healable by union data repair (see
        # mark_repair_gap)
        self.repair_gaps: Ranges = Ranges.EMPTY
        # bootstraps currently acquiring ranges for this store
        self.active_bootstraps: list = []
        # durability floors (reference: local/DurableBefore.java:39):
        #   durable_majority  -- ids below it are applied at a quorum of
        #     every replica set (advanced by SetShardDurable rounds)
        #   durable_universal -- applied at EVERY replica (SetGloballyDurable)
        self.durable_majority: ReducingRangeMap = ReducingRangeMap.EMPTY
        self.durable_universal: ReducingRangeMap = ReducingRangeMap.EMPTY
        # ids below this floor had their local per-txn state truncated
        # (reference: local/Cleanup.java + Commands.purge): probes answer
        # TRUNCATED -- the outcome was durable, the record is gone
        self.truncated_before: ReducingRangeMap = ReducingRangeMap.EMPTY

    # -- execution context ---------------------------------------------------
    # async_delay_us: when set (the adversarial simulator), every store op is
    # deferred through the scheduler by its returned delay -- modeling the
    # reference's async command loads / cache misses (DelayedCommandStores,
    # test impl/basic/DelayedCommandStores.java:71 + Cluster.java:414
    # isLoadedCheck). Ops stay atomic; only their ORDER relative to other
    # events (and each other across stores) changes.
    async_delay_us: Optional[Callable[[], int]] = None

    def execute(self, fn: Callable[["CommandStore"], None]) -> AsyncResult:
        """Run an operation against this store. Synchronous by default; the
        simulator injects async load delays via async_delay_us."""
        if self.async_delay_us is None:
            fn(self)
            return success(None)
        return self.submit(fn).map(lambda _: None)

    def submit(self, fn: Callable[["CommandStore"], object]) -> AsyncResult:
        if self.async_delay_us is None:
            return success(fn(self))
        out: AsyncResult = AsyncResult()

        def run():
            try:
                out.try_set_success(fn(self))
            except BaseException as e:  # noqa: BLE001 -- route to the chain
                out.try_set_failure(e)

        self.node.scheduler.once(self.async_delay_us() / 1000.0, run)
        return out

    # -- command access ------------------------------------------------------
    def command(self, txn_id: TxnId) -> Command:
        cmd = self.commands.get(txn_id)
        if cmd is None:
            cmd = Command(txn_id)
            self.commands[txn_id] = cmd
        return cmd

    def command_if_present(self, txn_id: TxnId) -> Optional[Command]:
        return self.commands.get(txn_id)

    def cfk(self, key: Key) -> CommandsForKey:
        c = self.cfks.get(key)
        if c is None:
            c = CommandsForKey(key)
            self.cfks[key] = c
        return c

    # -- epoch-aware ownership ----------------------------------------------
    @property
    def ranges(self) -> Ranges:
        """Union of owned ranges over every known epoch: the conservative
        scope for witnessing/scans (old-epoch coordinations must still find
        their conflicts here after a handover)."""
        return self._owned_union

    def set_owned(self, epoch: int, owned: Ranges) -> tuple:
        """Record what this store owns at `epoch`; returns (added, removed)
        vs the newest prior epoch (reference: CommandStores.updateTopology,
        local/CommandStores.java:646)."""
        prev_epochs = [e for e in self._owned_by_epoch if e < epoch]
        prev = self._owned_by_epoch[max(prev_epochs)] if prev_epochs else Ranges.EMPTY
        self._owned_by_epoch[epoch] = owned
        self._owned_union = self._owned_union.union(owned)
        return owned.difference(prev), prev.difference(owned)

    def current_owned(self) -> Ranges:
        if not self._owned_by_epoch:
            return Ranges.EMPTY
        return self._owned_by_epoch[max(self._owned_by_epoch)]

    def mark_safe_to_read(self, ranges: Ranges) -> None:
        """Bookkeeping of completed acquisitions (asserted by tests). Reads
        gate on data GAPS (has_gap -- a replica that merely lost a range can
        still serve; one awaiting a snapshot cannot), not on this set."""
        self.safe_to_read = self.safe_to_read.union(ranges)

    # -- ownership -----------------------------------------------------------
    def owns(self, seekables: Seekables) -> bool:
        return seekables.intersects(self.ranges)

    def owned(self, seekables: Seekables) -> Seekables:
        return seekables.slice(self.ranges)

    def owned_keys(self, seekables: Seekables) -> Keys:
        Invariants.check_argument(isinstance(seekables, Keys))
        return seekables.slice(self.ranges)

    # -- the deps/timestamp hot path ----------------------------------------
    def max_conflict_ts(self, seekables: Seekables) -> Optional[Timestamp]:
        """Max witnessed conflict timestamp over the given keys/ranges
        (reference: MaxConflicts, local/MaxConflicts.java)."""
        out: Optional[Timestamp] = None
        if isinstance(seekables, Keys):
            for k in seekables:
                out = Timestamp.merge_max(out, self.max_conflicts_by_key.get(k))
                out = Timestamp.merge_max(out, self.max_conflicts.get(k))
        else:
            for r in seekables:
                out = self.max_conflicts.fold_over_range(
                    r.start, r.end, Timestamp.merge_max, out)
            for k, v in self.max_conflicts_by_key.items():
                if seekables.contains_key(k):
                    out = Timestamp.merge_max(out, v)
        return out

    def update_max_conflicts(self, seekables: Seekables, ts: Timestamp) -> None:
        if isinstance(seekables, Keys):
            by_key = self.max_conflicts_by_key
            for k in seekables:
                prev = by_key.get(k)
                if prev is None or ts > prev:
                    by_key[k] = ts
            if self.cmd_plane is not None:
                # keep the device kmax lanes tracking the host fold
                self.cmd_plane.on_max_conflict(seekables, ts)
        else:
            for r in seekables:
                self.max_conflicts = self.max_conflicts.with_range(
                    r.start, r.end, ts, Timestamp.merge_max)

    def preaccept_timestamp(self, txn_id: TxnId, seekables: Seekables,
                            permit_fast_path: bool) -> Timestamp:
        """Propose the witnessed timestamp for a PreAccept (reference:
        CommandStore.preaccept, local/CommandStore.java:322-347): txnId itself
        iff the fast path is still possible, else a fresh unique timestamp
        above every witnessed conflict. A txn below an ExclusiveSyncPoint
        floor (or past its preaccept expiry) gets a REJECTED timestamp, which
        its coordinator turns into an invalidation."""
        if self._rejects(txn_id, seekables):
            return self.node.unique_now(txn_id.as_timestamp()).as_rejected()
        if txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT:
            # an ESP always witnesses at its own id: it has no executeAt of
            # its own, and marking the reject floor happened at registration
            return txn_id
        min_non_conflicting = self._max_conflict_resolved(txn_id, seekables)
        if (permit_fast_path
                and (min_non_conflicting is None or txn_id >= min_non_conflicting)
                and txn_id.epoch >= self.node.epoch):
            return txn_id
        return self.node.unique_now(min_non_conflicting or txn_id)

    def _max_conflict_resolved(self, txn_id: TxnId,
                               seekables: Seekables) -> Optional[Timestamp]:
        """Max-conflict via the device kernel when a resolver is installed
        (merged with the host range map, which tracks range-domain txns);
        host scan otherwise. In batched mode the resolver declines (the O(1)
        incremental host map is faster than a synchronous device round trip)."""
        if self.deps_resolver is not None:
            handled, device_max = self.deps_resolver.max_conflict(
                self, txn_id, seekables)
            if handled:
                return self._merge_range_map_conflicts(device_max, seekables)
        return self.max_conflict_ts(seekables)

    def _merge_range_map_conflicts(self, out: Optional[Timestamp],
                                   seekables: Seekables) -> Optional[Timestamp]:
        """Fold the host range map (range-domain registrations, which the
        device active set does not mirror) into a device max-conflict."""
        if not self.max_conflicts.is_empty():
            if isinstance(seekables, Keys):
                for k in seekables:
                    out = Timestamp.merge_max(out, self.max_conflicts.get(k))
            else:
                for r in seekables:
                    out = self.max_conflicts.fold_over_range(
                        r.start, r.end, Timestamp.merge_max, out)
        return out

    def _rejects(self, txn_id: TxnId, seekables: Seekables) -> bool:
        """Reject-before fold + expiry (reference: CommandStore.preaccept
        :326-331). Expiry never applies to sync points."""
        if not self.reject_before.is_empty():
            acc = False
            if isinstance(seekables, Keys):
                for k in seekables:
                    floor = self.reject_before.get(k)
                    if floor is not None and txn_id.as_timestamp() < floor:
                        return True
            else:
                def fold(hit, floor):
                    return hit or txn_id.as_timestamp() < floor
                for r in seekables:
                    acc = self.reject_before.fold_over_range(r.start, r.end, fold, acc)
                if acc:
                    return True
        if not txn_id.kind.is_sync_point:
            timeout_us = self.node.agent.pre_accept_timeout_ms() * 1000.0
            if self.node.time_service.now_micros() - txn_id.hlc >= timeout_us:
                return True
        return False

    def mark_exclusive_sync_point(self, txn_id: TxnId, seekables: Seekables) -> None:
        """At ESP preaccept: advance the reject floor (reference:
        CommandStore.markExclusiveSyncPoint, local/CommandStore.java:301)."""
        ts = txn_id.as_timestamp()
        for r in _as_ranges(seekables):
            self.reject_before = self.reject_before.with_range(
                r.start, r.end, ts, Timestamp.merge_max)

    def mark_exclusive_sync_point_locally_applied(self, txn_id: TxnId,
                                                  seekables: Seekables) -> None:
        """At ESP local apply: every conflicting txn below it has applied
        locally -- advance RedundantBefore (reference:
        CommandStore.markExclusiveSyncPointLocallyApplied, :310)."""
        ts = txn_id.as_timestamp()
        for r in _as_ranges(seekables):
            self.redundant_before = self.redundant_before.with_range(
                r.start, r.end, ts, Timestamp.merge_max)

    # -- durability + truncation (reference: DurableBefore.java:39,
    # Cleanup.java, cfk/Pruning.java:41) -------------------------------------
    def mark_shard_durable(self, sync_id: TxnId, ranges: Ranges) -> None:
        """Everything below `sync_id` on `ranges` is applied at a quorum of
        every replica set (a durability round's ExclusiveSyncPoint reached an
        applied quorum). Advances the majority floor and truncates."""
        ts = sync_id.as_timestamp()
        for r in ranges.intersection(self.ranges):
            self.durable_majority = self.durable_majority.with_range(
                r.start, r.end, ts, Timestamp.merge_max)
        self.cleanup()

    def mark_globally_durable(self, segments) -> None:
        """[(start, end, ts)]: ids below ts applied at EVERY replica."""
        for start, end, ts in segments:
            self.durable_universal = self.durable_universal.with_range(
                start, end, ts, Timestamp.merge_max)
        self.cleanup()

    def is_truncated(self, txn_id: TxnId, seekables: Seekables) -> bool:
        """Was this txn's local record truncated? (Any owned part below the
        truncation floor: below it every txn either applied durably or was
        invalidated, and the record is gone either way.) Commit/apply refuse
        on this over the ROUTE scope; the progress resolver finalizes on the
        same scope (a mismatch -- refusing wide, resolving narrow -- left
        half-floored records in an endless probe->refuse loop), and a probe
        whose merged conclusion is TRUNCATED-with-outcome finalizes any
        refused local copies via Propagate."""
        if self.truncated_before.is_empty():
            return False
        ts = txn_id.as_timestamp()
        owned = self.owned(seekables)
        if isinstance(owned, Keys):
            return any((f := self.truncated_before.get(k)) is not None and ts < f
                       for k in owned)
        hit = False
        for r in _as_ranges(owned):
            hit = self.truncated_before.fold_over_range(
                r.start, r.end, lambda acc, f: acc or ts < f, hit)
        return hit

    def _below_floor(self, cmd, floor_map: ReducingRangeMap, owned) -> bool:
        """Is every owned key/range of `cmd` covered by a floor segment above
        its id? `owned` is the precomputed owned slice of the command's keys
        (None for a blind invalidation with no definition -- droppable only
        once the WHOLE owned slice is floored, else such records accumulate
        forever under chaos.)"""
        from accord_tpu_torch.local.status import Status as _S
        ts = cmd.txn_id.as_timestamp()
        if owned is None:
            return cmd.is_(_S.INVALIDATED) and all(
                floor_map.covers(r.start, r.end, lambda f: ts < f)
                for r in self.ranges)
        if isinstance(owned, Keys):
            return len(owned) > 0 and all(
                (f := floor_map.get(k)) is not None and ts < f
                for k in owned)
        return not owned.is_empty() and all(
            floor_map.covers(r.start, r.end, lambda f: ts < f)
            for r in _as_ranges(owned))

    def bootstrap_covers(self, txn_id: TxnId, seekables: Seekables) -> bool:
        """Did this store's bootstrap snapshot deliver the txn's effects on
        every owned participant? (ALL owned keys floored above the id: the
        txn will never individually commit/apply here, and nothing needs to.)"""
        if self.bootstrapped_at.is_empty():
            return False
        ts = txn_id.as_timestamp()
        owned = self.owned(seekables)
        if isinstance(owned, Keys):
            return len(owned) > 0 and all(
                (f := self.bootstrapped_at.get(k)) is not None and ts < f
                for k in owned)
        return not owned.is_empty() and all(
            self.bootstrapped_at.covers(r.start, r.end, lambda f: ts < f)
            for r in _as_ranges(owned))

    def cleanup(self) -> None:
        """Two truncation tiers (reference: local/Cleanup.java deciding the
        erase level, Commands.purge):

        TIER A, *shrink* (reference TRUNCATE_WITH_OUTCOME), below
        min(durable_majority, redundant_before): the conflict-registry entries
        (cfk rows, device lanes) are dropped -- bounding the deps scans -- but
        the Command record RETAINS its outcome (txn, executeAt, deps, writes,
        result). A straggler replica not in the applied quorum can still
        repair from a CheckStatus probe, and needs the retained deps to order
        the replayed applies; erasing outcomes at mere majority durability
        would strand it forever (the round-2 no-quiescence liveness bug).

        TIER B, *erase*, below min(durable_universal, redundant_before): every
        replica has applied it, so nobody can ever need the outcome again --
        drop the record and advance the truncation horizon; probes answer
        TRUNCATED. The floor is an ExclusiveSyncPoint id, and the LATEST sync
        point is never below its own floor, so it survives to carry the
        transitive ordering edge for laggards."""
        from accord_tpu_torch.utils.range_map import merge as _merge, min_intersection
        # the two tiers are independent: a replica that missed the one-shot
        # SetShardDurable broadcast (empty majority floor) must still erase
        # when the universal floor reaches it
        shrink_floor = min_intersection(self.durable_majority, self.redundant_before)
        erase_floor = min_intersection(self.durable_universal, self.redundant_before)
        if shrink_floor.is_empty() and erase_floor.is_empty():
            return
        from accord_tpu_torch.local.status import Status as _S
        erased = []
        for txn_id, cmd in self.commands.items():
            if not (cmd.has_been(_S.APPLIED) or cmd.is_(_S.INVALIDATED)):
                continue
            if cmd.waiters:
                continue  # someone still watches it; let them resolve first
            owned = self.owned(cmd.txn.keys) if cmd.txn is not None else None
            if not erase_floor.is_empty() \
                    and self._below_floor(cmd, erase_floor, owned):
                erased.append(txn_id)
            elif not cmd.cleaned and not shrink_floor.is_empty() \
                    and self._below_floor(cmd, shrink_floor, owned):
                self._shrink(cmd)
        for txn_id in erased:
            cmd = self.commands.pop(txn_id)
            if not cmd.cleaned:
                self._deregister(cmd)
            self.progress_log.clear(txn_id)
        if not shrink_floor.is_empty():
            # PER-KEY cfk pruning (reference: cfk prunedBefore,
            # local/cfk/Pruning.java:41): applied entries below a key's
            # majority floor leave the registry even while their COMMAND
            # record lives on (partially-floored commands, retained outcomes,
            # lingering waiters) -- the injected floor dep subsumes their
            # ordering for every future scan. Bounds per-key set sizes
            # between truncation rounds.
            for key in list(self.cfks):
                floor = shrink_floor.get(key)
                if floor is None:
                    continue
                c = self.cfks[key]
                pruned = c.prune_below(floor)
                if pruned and self.deps_resolver is not None:
                    for t in pruned:
                        self.deps_resolver.on_prune(self, t, (key,))
                if c.is_empty():
                    del self.cfks[key]
        if not erase_floor.is_empty():
            # advance the truncation horizon over the whole erased region: ids
            # below it either applied durably, were invalidated, or can never
            # commit (the sync point's reject floor covers new arrivals)
            prev = self.truncated_before
            self.truncated_before = _merge(self.truncated_before, erase_floor,
                                           Timestamp.merge_max)
            if self.truncated_before != prev:
                self.reevaluate_waiters()

    def _shrink(self, cmd) -> None:
        # deps are RETAINED: a straggler repairing its copy from our
        # CheckStatus reply needs them to order the replayed applies (writes
        # applied dep-free would interleave out of order); the record (deps
        # included) is reclaimed at tier B once no straggler can exist
        self._deregister(cmd)
        cmd.waiting_on = None
        cmd.cleaned = True
        self.progress_log.clear(cmd.txn_id)

    def _deregister(self, cmd) -> None:
        """Drop a command's conflict-registry footprint (cfk rows, range
        registration, device active-set lane)."""
        txn_id = cmd.txn_id
        if cmd.txn is not None:
            owned = self.owned(cmd.txn.keys)
            if isinstance(owned, Keys):
                for k in owned:
                    c = self.cfks.get(k)
                    if c is not None:
                        c.remove(txn_id)
                        if c.is_empty():
                            del self.cfks[k]
        self.range_txns.pop(txn_id, None)
        self.range_index.remove(txn_id)
        if self.deps_resolver is not None:
            self.deps_resolver.on_truncate(self, txn_id)
        if self.exec_plane is not None:
            self.exec_plane.on_erased(txn_id)

    # -- bootstrap floor (reference: local/Bootstrap.java:81 doc :28-80) -----
    def set_bootstrap_floor(self, sync_id: TxnId, ranges: Ranges) -> None:
        """The bootstrap's ExclusiveSyncPoint id becomes the floor for
        `ranges`: everything ordered below it arrives via the fetched snapshot
        rather than individual applies, so waiting on such deps would hang.
        Re-evaluates every blocked command since previously-registered waits
        may now be elided."""
        ts = sync_id.as_timestamp()
        for r in ranges:
            self.bootstrapped_at = self.bootstrapped_at.with_range(
                r.start, r.end, ts, Timestamp.merge_max)
        self.reevaluate_waiters()

    def reevaluate_waiters(self) -> None:
        """A floor advanced (bootstrap or truncation) or a range moved away:
        previously-registered wait edges may now be elided -- recompute each
        waiter's needed set and release the ones that became complete.

        Ownership elision: a dep whose every shared key left this store's
        current ownership can never individually commit here (nobody messages
        a non-owner), while the handover barrier covered its ordering for the
        new owners -- keeping the edge would freeze the waiter forever (and
        with it quiescence). If such a dep is a write whose effects never
        arrived, the lost slice's data is incomplete: mark the gap so
        historical reads there report unavailable instead of serving a stale
        list (reference: markShardStale / RangeUnavailable escalation)."""
        from accord_tpu_torch.local import commands as _commands
        # only commands with pending wait edges can change: the live_waiters
        # index is exactly that set (stale entries self-clean in the sweep),
        # and iterating every command here made churn ticks quadratic
        for txn_id in list(self.live_waiters):
            cmd = self.command_if_present(txn_id)
            wo = cmd.waiting_on if cmd is not None else None
            if wo is None or wo.is_done():
                continue
            needed = _commands.needed_dep_ids(self, cmd)
            changed = False
            for dep_id in list(wo.commit | wo.apply):
                drop = dep_id not in needed
                if not drop and self.maybe_elide_lost_dep(cmd, dep_id):
                    continue
                if drop:
                    wo.commit.discard(dep_id)
                    wo.apply.discard(dep_id)
                    d = self.command_if_present(dep_id)
                    if d is not None:
                        d.remove_waiter(cmd.txn_id)
                    changed = True
            if changed:
                if self.exec_plane is not None:
                    # primary plane: the release comes from the frontier
                    # harvest (on_edges_changed armed the tick)
                    self.exec_plane.on_edges_changed(cmd)
                elif wo.is_done():
                    self.node.scheduler.once(
                        0.0, lambda c=cmd: _commands.maybe_execute(self, c))

    def maybe_elide_lost_dep(self, cmd, dep_id: TxnId) -> bool:
        """Elide the wait edge on dep_id iff every key it shares with `cmd`
        left this store's current ownership (the single test both the
        reevaluation pass and the progress sweep apply)."""
        if cmd.deps is None:
            return False
        shared = cmd.deps.participants_of(dep_id)
        if shared is None or not len(shared) \
                or self.current_owned().intersects(shared):
            return False
        self.elide_lost_dep(cmd, dep_id)
        return True

    def elide_lost_dep(self, cmd, dep_id: TxnId) -> None:
        """Drop one wait edge whose shared keys all left current ownership
        (it can never individually resolve here -- see reevaluate_waiters).

        If the dep is a write whose effects never arrived, the slice's local
        copy is incomplete: mark the data gap so reads there nack instead of
        serving a stale list (verified necessary: without it, churn seeds
        produce lost-update anomalies the verifier catches). Gaps on ranges
        that later cycle back are healed by the progress engine's
        gap-healing bootstrap (impl/progress.py), so marking cannot
        permanently poison an owned range."""
        from accord_tpu_torch.local import commands as _commands
        from accord_tpu_torch.local.status import Status as _S
        wo = cmd.waiting_on
        if wo is None:
            return
        if dep_id.kind.is_write and cmd.deps is not None:
            d = self.command_if_present(dep_id)
            if d is None or not d.has_been(_S.APPLIED):
                shared = cmd.deps.participants_of(dep_id)
                lost = shared.to_ranges() if isinstance(shared, Keys) \
                    else shared
                self.mark_gap(lost.intersection(self.ranges))
        wo.commit.discard(dep_id)
        wo.apply.discard(dep_id)
        d = self.command_if_present(dep_id)
        if d is not None:
            d.remove_waiter(cmd.txn_id)
        if wo.is_done():
            self.live_waiters.discard(cmd.txn_id)
        if self.exec_plane is not None:
            # primary plane: the frontier harvest performs the release
            self.exec_plane.on_edges_changed(cmd)
        elif wo.is_done():
            self.node.scheduler.once(
                0.0, lambda c=cmd: _commands.maybe_execute(self, c))

    def mark_gap(self, ranges: Ranges) -> None:
        if ranges.is_empty():
            return
        self.data_gaps = self.data_gaps.union(ranges)
        self.progress_log.gap_marked()

    def mark_repair_gap(self, ranges: Ranges) -> None:
        """A gap whose missing data is UNIVERSALLY APPLIED (a truncated write
        this store never applied): every then-replica's durable data store
        holds it, so it heals by unconditional union data repair
        (ProgressEngine._run_data_repair) rather than an ESP+snapshot
        bootstrap -- whose gap-checked fetch deadlocks when every current
        replica is itself gapped."""
        if ranges.is_empty():
            return
        self.repair_gaps = self.repair_gaps.union(ranges)
        self.mark_gap(ranges)

    def fill_gap(self, ranges: Ranges) -> None:
        self.data_gaps = self.data_gaps.difference(ranges)
        self.repair_gaps = self.repair_gaps.difference(ranges)

    def has_gap(self, ranges: Ranges) -> bool:
        return self.data_gaps.intersects(ranges)

    def apply_ranges_for(self, txn_id: TxnId) -> Ranges:
        """The sub-ranges of this store where `txn_id`'s writes must actually
        be applied: everything except ranges whose bootstrap floor is above
        the txn (there, the fetched snapshot already delivered its effects;
        reference: RedundantBefore.PRE_BOOTSTRAP gating in Commands.apply)."""
        if self.bootstrapped_at.is_empty():
            return self.ranges
        ts = txn_id.as_timestamp()
        out: Ranges = Ranges.EMPTY
        for r in self.ranges:
            # keep the parts of r NOT floored above ts
            floored = Ranges(Range(s, e) for s, e in
                             self.bootstrapped_at.segments_where(
                                 r.start, r.end, lambda f: ts < f))
            out = out.union(Ranges([r]).difference(floored))
        return out

    def is_rejected_if_not_preaccepted(self, txn_id: TxnId,
                                       seekables: Seekables) -> bool:
        """Would the reject floor refuse this txn were it arriving now?
        (reference: CommandStore.isRejectedIfNotPreAccepted,
        local/CommandStore.java:589 -- gates Accept/inference for txns this
        store never witnessed)."""
        if self.reject_before.is_empty():
            return False
        ts = txn_id.as_timestamp()
        if isinstance(seekables, Keys):
            return any((floor := self.reject_before.get(k)) is not None
                       and ts < floor for k in seekables)
        hit = False
        for r in seekables:
            hit = self.reject_before.fold_over_range(
                r.start, r.end, lambda acc, floor: acc or ts < floor, hit)
        return hit

    def calculate_deps(self, txn_id: TxnId, seekables: Seekables,
                       before: Timestamp) -> Deps:
        """All witnessed conflicting txns that started before `before`
        (reference: PreAccept.calculatePartialDeps, messages/PreAccept.java:245).
        Delegates to the DepsResolver SPI when installed (TPU path)."""
        if self.deps_resolver is not None:
            raw = self.deps_resolver.resolve_one(self, txn_id, seekables, before)
        else:
            raw = self.host_calculate_deps(txn_id, seekables, before)
        return self.inject_dep_floor(txn_id, seekables, raw, before)

    def inject_dep_floor(self, txn_id: TxnId, seekables: Seekables,
                         deps: Deps, before: Timestamp) -> Deps:
        """Replace deps below the locally-applied ExclusiveSyncPoint floor
        with a single dep on the floor ESP itself (reference:
        RedundantBefore.collectDeps, local/RedundantBefore.java:49): the ESP
        witnessed and waited out everything below it, so one edge to it
        carries the same ordering with O(1) size. This is what keeps dep sets
        bounded by the inter-durability-round arrival rate instead of the
        total live-txn count.

        Only floors STRICTLY BELOW the subject's started-before bound apply:
        injecting a LATER sync point as a dep of an EARLIER subject inverts
        the order, and two awaits-all sync points pointing at each other
        deadlock (observed under churn+chaos+durability: a laggard ESP's
        deps query ran after a newer durability ESP had already applied)."""
        rb = self.redundant_before
        if rb.is_empty():
            return deps
        owned = self.owned(seekables)
        if isinstance(owned, Keys):
            floors = [(k, f) for k in owned
                      if (f := rb.get(k)) is not None and f < before]
            if not floors:
                return deps
            edges = KeyDepsBuilder()
            for k, f in floors:
                fid = TxnId.from_timestamp(f)
                if fid != txn_id:
                    edges.add(k, fid)
            kd = deps.key_deps
            # fast path (the steady state): no row holds an id below its
            # floor -- rows are sorted, so checking each row's FIRST id
            # suffices; the result is then a pure linear union with the edges
            if not any(self._row_has_id_below(kd, k, f) for k, f in floors):
                return Deps(kd.union(edges.build()), deps.range_deps)
            kb = KeyDepsBuilder()
            fmap = dict(floors)
            for k, ids in kd.items():
                f = fmap.get(k)
                if f is None:
                    kb.add_all(k, ids)
                else:
                    kb.add_all(k, [t for t in ids if not t < f])
            for k, f in floors:
                fid = TxnId.from_timestamp(f)
                if fid != txn_id:
                    kb.add(k, fid)
            # key subjects carry no range rows of their own; pass them through
            return Deps(kb.build(), deps.range_deps)
        # range subjects (sync points): once per durability round, not hot
        kb = KeyDepsBuilder()
        rbld = RangeDepsBuilder()
        for r, ids in deps.range_deps.items():
            fmin = _min_floor_over_range(rb, r.start, r.end)
            if fmin is not None and not fmin < before:
                fmin = None
            kept = ids if fmin is None else [t for t in ids if not t < fmin]
            if kept:
                rbld.add_all(r, kept)
        for rr in _as_ranges(owned):
            for s, e, f in rb.segments():
                lo, hi = max(s, rr.start), min(e, rr.end)
                if lo < hi and f is not None and f < before:
                    fid = TxnId.from_timestamp(f)
                    if fid != txn_id:
                        rbld.add(Range(lo, hi), fid)
        for k, ids in deps.key_deps.items():
            f = rb.get(k)
            if f is not None and not f < before:
                f = None
            kept = ids if f is None else [t for t in ids if not t < f]
            if kept:
                kb.add_all(k, kept)
        return Deps(kb.build(), rbld.build())

    @staticmethod
    def _row_has_id_below(kd, key, floor) -> bool:
        from bisect import bisect_left
        i = bisect_left(kd.keys, key)
        if i >= len(kd.keys) or kd.keys[i] != key:
            return False
        lo, hi = kd.offsets[i], kd.offsets[i + 1]
        # value_idx rows are sorted dictionary indices and the dictionary is
        # sorted by id, so the row's first entry is its minimum id
        return hi > lo and kd.txn_ids[kd.value_idx[lo]] < floor

    def calculate_deps_async(self, txn_id: TxnId, seekables: Seekables,
                             before: Timestamp) -> AsyncResult:
        """calculate_deps, micro-batched through the resolver's per-node tick
        alongside queued PreAccepts (the Accept round's deps query is as hot
        as PreAccept's under contention -- the slow path runs both)."""
        resolver = self.deps_resolver
        if resolver is None or not hasattr(resolver, "enqueue_deps") \
                or self.batch_window_ms is None:
            return success(self.calculate_deps(txn_id, seekables, before))
        return resolver.enqueue_deps(self, txn_id, seekables, before)

    # -- the micro-batched PreAccept path ------------------------------------
    def submit_preaccept(self, txn_id: TxnId, partial_txn, route,
                         ballot=None) -> AsyncResult:
        """PreAccept against this store. With a batch resolver installed,
        subjects queue on the resolver's per-NODE tick: every store's queued
        work drains through ONE asynchronously-dispatched deps kernel call
        (see ops/resolver.BatchDepsResolver for the pipeline design).
        Completes with (outcome, witnessed_at, deps)."""
        from accord_tpu_torch.primitives.timestamp import Ballot
        ballot = ballot or Ballot.ZERO
        resolver = self.deps_resolver
        if resolver is None or not hasattr(resolver, "enqueue_preaccept") \
                or self.batch_window_ms is None:
            return success(self._preaccept_now(txn_id, partial_txn, route, ballot))
        return resolver.enqueue_preaccept(self, txn_id, partial_txn, route,
                                          ballot)

    def _preaccept_now(self, txn_id, partial_txn, route, ballot):
        from accord_tpu_torch.local.commands import AcceptOutcome
        if self.cmd_plane is not None:
            from accord_tpu_torch.ops.cmd_plane import CmdOp
            outcome = self.cmd_plane.eval_batch(
                [CmdOp.preaccept(txn_id, partial_txn, route,
                                 ballot)])[0].outcome
        else:
            from accord_tpu_torch.local import commands
            outcome = commands.preaccept(self, txn_id, partial_txn, route,
                                         ballot)
        if outcome in (AcceptOutcome.REJECTED_BALLOT, AcceptOutcome.TRUNCATED):
            return (outcome, None, None)
        witnessed = self.command(txn_id).execute_at
        deps = self.calculate_deps(txn_id, self.owned(partial_txn.keys), witnessed)
        return (outcome, witnessed, deps)

    # -- command-plane transition routing ------------------------------------
    # Accept/Commit/Apply transitions route through the device command arena
    # (ops/cmd_plane.py) when one is attached; the Python handlers otherwise.
    # Single-op batches here; coordinators that hold several transitions for
    # one store (the resolver drain, the bench) call eval_batch directly.
    def accept_op(self, txn_id, ballot, route, keys, execute_at, deps=None):
        if self.cmd_plane is not None:
            from accord_tpu_torch.ops.cmd_plane import CmdOp
            return self.cmd_plane.eval_batch(
                [CmdOp.accept(txn_id, ballot, route, keys, execute_at,
                              deps)])[0].outcome
        from accord_tpu_torch.local import commands
        return commands.accept(self, txn_id, ballot, route, keys,
                               execute_at, deps)

    def commit_op(self, txn_id, route, txn, execute_at, deps):
        if self.cmd_plane is not None:
            from accord_tpu_torch.ops.cmd_plane import CmdOp
            return self.cmd_plane.eval_batch(
                [CmdOp.commit(txn_id, route, txn, execute_at,
                              deps)])[0].outcome
        from accord_tpu_torch.local import commands
        return commands.commit(self, txn_id, route, txn, execute_at, deps)

    def apply_op(self, txn_id, route, txn, execute_at, deps, writes, result):
        if self.cmd_plane is not None:
            from accord_tpu_torch.ops.cmd_plane import CmdOp
            return self.cmd_plane.eval_batch(
                [CmdOp.apply(txn_id, route, txn, execute_at, deps, writes,
                             result)])[0].outcome
        from accord_tpu_torch.local import commands
        return commands.apply(self, txn_id, route, txn, execute_at, deps,
                              writes, result)

    def host_range_deps(self, txn_id: TxnId, seekables: Seekables,
                        before: Timestamp) -> Deps:
        """Only the range-domain conflicts (the device path computes key-domain
        deps exactly; range txns are tracked host-side and unioned in)."""
        kb = KeyDepsBuilder()
        kind = txn_id.kind
        Invariants.check_argument(isinstance(seekables, Keys))
        for k in self.owned_keys(seekables):
            for rid in self.range_index.stab(int(k)):
                if rid != txn_id and rid < before and kind.witnesses(rid.kind):
                    kb.add(k, rid)
        return Deps(kb.build())

    def host_calculate_deps(self, txn_id: TxnId, seekables: Seekables,
                            before: Timestamp) -> Deps:
        kb = KeyDepsBuilder()
        rb = RangeDepsBuilder()
        kind = txn_id.kind
        if isinstance(seekables, Keys):
            for k in self.owned_keys(seekables):
                c = self.cfks.get(k)
                if c is not None:
                    for dep in c.conflicts_before(txn_id, before):
                        kb.add(k, dep)
            # range txns intersecting these keys also conflict
            return Deps(kb.build(), rb.build()).union(
                self.host_range_deps(txn_id, seekables, before))
        else:
            owned = seekables.slice(self.ranges)
            # key txns within the ranges
            for k, c in self.cfks.items():
                if owned.contains_key(k):
                    for dep in c.conflicts_before(txn_id, before):
                        rb.add(Range.point(k), dep)
            # other range txns: candidates via the interval index
            candidates = set()
            for r in owned:
                candidates.update(self.range_index.over(r.start, r.end))
            for rid in candidates:
                if rid != txn_id and rid < before and kind.witnesses(rid.kind):
                    for r in self.range_txns[rid].intersection(owned):
                        rb.add(r, rid)
        return Deps(kb.build(), rb.build())

    # -- recovery scans ------------------------------------------------------
    def recovery_info(self, txn_id: TxnId, seekables: Seekables):
        """The three conflict scans a BeginRecovery answer needs (reference:
        messages/BeginRecovery.java:329-380):

          rejects_fast_path -- exists a conflicting txn that (a) started after
            txn_id with a proposed/decided executeAt whose deps do not witness
            txn_id, or (b) is stable, executes after txn_id, and does not
            witness it: either proves txn_id CANNOT have fast-path committed.
          earlier_committed_witness -- stable conflicts started before txn_id
            whose deps DO witness it.
          earlier_accepted_no_witness -- proposed conflicts started before
            txn_id, executing after it, whose deps do NOT witness it (must
            reach commit before recovery can safely propose the fast path).

        Returns (rejects_fast_path, earlier_committed_witness: Deps,
        earlier_accepted_no_witness: Deps).

        Witness checks are THREE-VALUED under transitive-dependency elision:
        a candidate's deps may carry txn_id only via a committed write whose
        agreed deps include it (the cover chain). True = proven witnessed,
        False = proven not (every chain locally resolvable), None = unknown
        (a chain element is not committed here, so an elision made at
        another replica could hide txn_id behind it). Each flag takes its
        SAFE direction: `rejects` (enables invalidation) requires proof of
        non-witness; `ecw` requires proof of witness; `eanw` (forces an
        await) includes anything not proven witnessed."""
        rejects = False
        ecw = KeyDepsBuilder()
        eanw = KeyDepsBuilder()
        tau = txn_id.as_timestamp()

        def candidates_for_key(k):
            c = self.cfks.get(k)
            if c is not None:
                yield from c._infos.keys()
            yield from self.range_index.stab(int(k))

        if isinstance(seekables, Keys):
            owned_keys = self.owned_keys(seekables)
        else:
            owned_keys = Keys([k for k in self.cfks
                               if seekables.slice(self.ranges).contains_key(k)])
        for k in owned_keys:
            for cand in candidates_for_key(k):
                if cand == txn_id or not cand.kind.witnesses(txn_id.kind):
                    continue
                cmd = self.commands.get(cand)
                if cmd is None or cmd.is_(Status.INVALIDATED) \
                        or cmd.is_(Status.TRUNCATED):
                    continue
                if cmd.deps is None:
                    continue  # no proposal/decision to inspect yet
                has_proposal = cmd.status.has_been(Status.ACCEPTED)
                is_stable = cmd.status.is_stable
                w = self._witness_status(k, cmd.deps, txn_id, set())
                if cand > txn_id:
                    if has_proposal and w is False:
                        rejects = True
                else:  # started before us
                    if is_stable and w is True:
                        ecw.add(k, cand)
                    elif has_proposal and not is_stable and w is not True \
                            and cmd.execute_at is not None and cmd.execute_at > tau:
                        eanw.add(k, cand)
                if is_stable and w is False \
                        and cmd.execute_at is not None and cmd.execute_at > tau:
                    rejects = True
        return rejects, Deps(ecw.build()), Deps(eanw.build())

    def _witness_status(self, k, deps: Deps, target: TxnId,
                        visited: set) -> Optional[bool]:
        """Does `deps` witness `target` at key k, through committed-cover
        chains? True/False are proofs; None = unresolvable locally (see
        recovery_info doc). A cover of `target` is a committed WRITE whose
        executeAt is above target's -- by TXN ID it may sort either side of
        target (a slow-path cover's id can be lower), so the walk filters by
        executeAt, not id order."""
        if deps.contains_for(k, target):
            return True
        tau = target.as_timestamp()
        unknown = False
        for d in deps.for_key(k):
            if d == target or not d.kind.is_write or d in visited:
                continue
            visited.add(d)
            dcmd = self.commands.get(d)
            if dcmd is not None and dcmd.deps is not None \
                    and dcmd.status.has_been(Status.COMMITTED) \
                    and not dcmd.is_(Status.INVALIDATED):
                if dcmd.execute_at is None or not dcmd.execute_at > tau:
                    continue  # executes at/below target: cannot cover it
                sub = self._witness_status(k, dcmd.deps, target, visited)
                if sub is True:
                    return True
                if sub is None:
                    unknown = True
            else:
                # a write dep not committed locally: an elision made at the
                # replica that resolved `deps` could hide target behind it
                unknown = True
        return None if unknown else False

    def register_commit_cover(self, txn_id: TxnId, execute_at: Timestamp,
                              deps: Deps) -> None:
        """A key-domain WRITE committed with agreed `deps`: mark each per-key
        dep it REALLY waits for (committed, lower executeAt) as transitively
        covered by it (reference: the cfk's transitive dependency elision,
        CommandsForKey.java:146-151). Future subjects that take the write as
        a dep are ordered after everything in its wait graph, so the scan
        may elide them. The monotone cover_seq stamps each cover so the
        async device decode can ignore covers younger than its kernel
        snapshot (the covering write would be missing from the reply)."""
        self.cover_seq += 1
        for k, ids in deps.key_deps.items():
            if not self.ranges.contains_key(k):
                continue
            c = self.cfks.get(k)
            if c is not None:
                c.mark_covered(self.cover_seq, txn_id, execute_at, ids)

    # -- registration (feeds the conflict registry) -------------------------
    def register(self, txn_id: TxnId, seekables: Seekables, status: CfkStatus,
                 witnessed_at: Timestamp,
                 execute_at: Optional[Timestamp] = None) -> None:
        owned = self.owned(seekables)
        if isinstance(owned, Keys):
            for k in owned:
                self.cfk(k).update(txn_id, status, execute_at)
        else:
            if status == CfkStatus.INVALIDATED:
                self.range_txns.pop(txn_id, None)
                self.range_index.remove(txn_id)
            else:
                prev = self.range_txns.get(txn_id)
                merged = prev.union(owned) if prev else owned
                self.range_txns[txn_id] = merged
                self.range_index.remove(txn_id)
                for r in merged:
                    self.range_index.add(txn_id, r.start, r.end)
        self.update_max_conflicts(owned, witnessed_at)
        if self.deps_resolver is not None:
            # incremental device active-set maintenance (append/lane update,
            # no re-encode): the whole TPU data plane hangs off this funnel
            self.deps_resolver.on_register(self, txn_id, owned, status,
                                           witnessed_at)


def _as_ranges(seekables: Seekables) -> Ranges:
    return seekables if isinstance(seekables, Ranges) else seekables.to_ranges()


def _min_floor_over_range(floor_map: ReducingRangeMap, start, end):
    """Min floor value over [start, end) when the map FULLY covers it, else
    None (a gap means some point has no floor, so nothing may be elided)."""
    if not floor_map.covers(start, end, lambda v: True):
        return None
    return floor_map.fold_over_range(
        start, end, lambda acc, v: v if acc is None or v < acc else acc, None)


class _NoopProgressLog:
    def __getattr__(self, name):
        return lambda *a, **k: None
