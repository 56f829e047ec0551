"""Bootstrap: acquiring history for a newly-owned range.

Role-equivalent to the reference's Bootstrap (local/Bootstrap.java:81, doc
:28-80): when a topology change hands this node a range it did not own in the
prior epoch, it must acquire every transaction below a floor before serving
reads. The flow:

  1. set the bootstrap floor from a freshly-minted ExclusiveSyncPoint id
     (BEFORE any message goes out, so the ESP's own commit -- whose deps are
     all below the floor and unknown here -- executes locally immediately);
  2. coordinate the ExclusiveSyncPoint over the added ranges (this also
     advances every replica's reject floor: txns below it can no longer
     commit);
  3. fetch the data snapshot from the prior epoch's replicas -- each source
     replies only after the sync point has applied locally there, so the
     snapshot contains everything below the floor (reference:
     impl/AbstractFetchCoordinator.java:60);
  4. merge the snapshot, mark the ranges safe to read.

Failures at any step retry with backoff (reference: Bootstrap's retry/
invalidate loop); the Agent hears about each failed attempt.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Set

from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.fetch import FetchData, FetchNack, FetchOk
from accord_tpu_torch.primitives.keyspace import Ranges
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.utils.async_ import AsyncResult, success
from accord_tpu_torch.utils.invariants import Invariants


class Bootstrap:
    RETRY_BACKOFF_MS = 400.0

    def __init__(self, node, store, epoch: int, ranges: Ranges):
        self.node = node
        self.store = store
        self.epoch = epoch
        self.ranges = ranges
        self.result: AsyncResult = AsyncResult()
        self.attempt = 0
        self.aborted = False

    @classmethod
    def run(cls, node, store, epoch: int, ranges: Ranges) -> AsyncResult:
        if epoch <= 1:
            # genesis: there is no history to acquire
            store.mark_safe_to_read(ranges)
            return success(None)
        self = cls(node, store, epoch, ranges)
        # until the snapshot arrives this store's data for `ranges` has a
        # gap: it must not serve fetches for them (FetchData nacks)
        store.mark_gap(ranges)
        store.active_bootstraps.append(self)
        self._start()
        return self.result

    def abort(self) -> None:
        """A later epoch removed (some of) these ranges before the snapshot
        arrived: stop. The data gap REMAINS marked -- this store's history
        for the ranges is genuinely incomplete, and only a future successful
        bootstrap may clear it (reference: Bootstrap invalidation on topology
        change, local/Bootstrap.java:81)."""
        if self.aborted:
            return
        self.aborted = True
        if self in self.store.active_bootstraps:
            self.store.active_bootstraps.remove(self)
        # release the epoch-sync waiter: the obligation for removed ranges is
        # moot (a still-owned remainder is re-bootstrapped by the caller)
        self.result.try_set_success(None)

    # -- step 1+2: the ExclusiveSyncPoint ------------------------------------
    def _start(self) -> None:
        from accord_tpu_torch.coordinate.syncpoint import CoordinateSyncPoint
        from accord_tpu_torch.primitives.timestamp import TxnKind
        if self.aborted:
            return
        self.attempt += 1
        sp = CoordinateSyncPoint.build(self.node, TxnKind.EXCLUSIVE_SYNC_POINT,
                                       self.ranges)
        # floor first: the ESP's commit must execute here without waiting on
        # pre-floor deps this store has never seen
        self.store.set_bootstrap_floor(sp.txn_id, self.ranges)
        sp.start() \
            .on_success(self._fetch) \
            .on_failure(lambda f: self._retry("sync_point", f))

    def _retry(self, phase: str, failure) -> None:
        if self.aborted:
            return
        # one retry per failure, whoever fires first (the agent's callback or
        # our backoff timer) -- never two concurrent bootstraps of the ranges
        token = object()
        self._retry_token = token

        def retry_once():
            if getattr(self, "_retry_token", None) is token:
                self._retry_token = None
                self._start()

        self.node.agent.on_failed_bootstrap(phase, self.ranges,
                                            retry_once, failure)
        backoff = min(self.RETRY_BACKOFF_MS * self.attempt, 3000.0)
        self.node.scheduler.once(backoff, retry_once)

    # -- step 3: fetch from the prior epoch's replicas -----------------------
    def _fetch(self, sync_point) -> None:
        if self.aborted:
            return
        prev = self.node.topology_manager.for_epoch(self.epoch - 1)
        fetch = _FetchRound(self, sync_point, prev)
        fetch.start()

    # -- step 4 --------------------------------------------------------------
    def _finish(self, merged: Dict) -> None:
        if self.aborted:
            return
        self.node.data_store.merge_entries(merged)
        # seed the acquired ranges' conflict registry: the snapshot carries
        # data, not conflict history, so without this a fresh replica's
        # preaccept could witness a new txn BELOW already-committed
        # conflicts (reference: FetchMaxConflict establishing safe-to-read,
        # local/Bootstrap.java:239)
        self._fetch_max_conflict()

    def _fetch_max_conflict(self) -> None:
        # a transient failure retries ONLY this cheap timestamp read -- the
        # sync point and snapshot (steps 1-3) are already done and must not
        # be re-coordinated/re-transferred for it
        from accord_tpu_torch.coordinate.maxconflict import FetchMaxConflict
        if self.aborted:
            return

        def retry(failure):
            if self.aborted:
                return
            self.node.agent.on_failed_bootstrap(
                "max_conflict", self.ranges, lambda: None, failure)
            self.node.scheduler.once(self.RETRY_BACKOFF_MS,
                                     self._fetch_max_conflict)

        FetchMaxConflict.fetch(self.node, self.ranges) \
            .on_success(self._seed_and_complete) \
            .on_failure(retry)

    def _seed_and_complete(self, max_conflict) -> None:
        if self.aborted:
            return
        if max_conflict is not None:
            self.store.update_max_conflicts(self.ranges, max_conflict)
        if self in self.store.active_bootstraps:
            self.store.active_bootstraps.remove(self)
        self.store.fill_gap(self.ranges)
        self.store.mark_safe_to_read(self.ranges)
        self.result.try_set_success(None)


class _FetchRound(Callback):
    """One attempt to cover every added range with a snapshot from a prior-
    epoch replica; escalates through replicas per shard, retries the whole
    bootstrap if a shard's replicas are exhausted."""

    def __init__(self, parent: Bootstrap, sync_point, prev_topology):
        self.parent = parent
        self.sync_point = sync_point
        # per prior-epoch shard: the slice of our ranges it covers + sources
        self.pending: List[dict] = []
        for shard in prev_topology.shards_for(parent.ranges):
            covered = parent.ranges.intersection(Ranges.of(shard.range))
            sources = [n for n in shard.nodes if n != parent.node.id]
            if not sources:
                continue  # we were the only replica: nothing to fetch
            self.pending.append({"ranges": covered, "sources": sources,
                                 "next": 0, "done": False})
        self.merged: Dict = {}
        self.outstanding: Dict[NodeId, List[dict]] = {}
        self.failed = False

    def start(self) -> None:
        if not self.pending:
            self.parent._finish({})
            return
        by_source: Dict[NodeId, Ranges] = {}
        for entry in self.pending:
            src = entry["sources"][entry["next"]]
            entry["next"] += 1
            by_source.setdefault(src, Ranges.EMPTY)
            by_source[src] = by_source[src].union(entry["ranges"])
            self.outstanding.setdefault(src, []).append(entry)
        for src, ranges in sorted(by_source.items()):
            self.parent.node.send(
                src, FetchData(self.sync_point.sync_id,
                               self.sync_point.seekables, ranges), self)

    def on_success(self, from_node, reply) -> None:
        if self.failed or self.parent.aborted:
            return
        if isinstance(reply, FetchNack):
            self.on_failure(from_node, RuntimeError(
                f"source {from_node} bootstrap pending for {reply.ranges}"))
            return
        if not isinstance(reply, FetchOk):
            return
        for key, entries in reply.data.items():
            self.merged.setdefault(key, set()).update(entries)
        # a source can hold several outstanding fetches: only entries whose
        # ranges this reply actually covered are complete
        remaining = []
        for entry in self.outstanding.pop(from_node, ()):
            if not entry["done"] and reply.ranges.contains_ranges(entry["ranges"]):
                entry["done"] = True
            elif not entry["done"]:
                remaining.append(entry)
        if remaining:
            self.outstanding[from_node] = remaining
        if all(e["done"] for e in self.pending):
            self.parent._finish(self.merged)

    def on_failure(self, from_node, failure) -> None:
        if self.failed or self.parent.aborted:
            return
        retry = []
        for entry in self.outstanding.pop(from_node, ()):
            if entry["done"]:
                continue
            if entry["next"] >= len(entry["sources"]):
                # every replica of this shard failed: restart the bootstrap
                self.failed = True
                self.parent._retry("fetch", failure)
                return
            retry.append(entry)
        by_source: Dict[NodeId, Ranges] = {}
        for entry in retry:
            src = entry["sources"][entry["next"]]
            entry["next"] += 1
            by_source.setdefault(src, Ranges.EMPTY)
            by_source[src] = by_source[src].union(entry["ranges"])
            self.outstanding.setdefault(src, []).append(entry)
        for src, ranges in sorted(by_source.items()):
            self.parent.node.send(
                src, FetchData(self.sync_point.sync_id,
                               self.sync_point.seekables, ranges), self)
