"""Node-local epoch registry (reference: topology/TopologyManager.java:71).

Tracks every known epoch's Topology plus per-epoch sync state (which nodes
have acknowledged the epoch), and computes which Topologies a coordination
must contact: all epochs in [txn_id.epoch, execute_at.epoch], extended
backwards while older epochs are not yet fully synced (withUnsyncedEpochs).

Round-1 scope: epochs are append-only and sync tracking is quorum-of-acks;
range add/remove bookkeeping (addedRanges/removedRanges, closed/complete)
arrives with the topology-change milestone.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.async_ import AsyncResult
from accord_tpu_torch.utils.invariants import Invariants


class _EpochState:
    __slots__ = ("topology", "sync_acks", "synced", "ready")

    def __init__(self, topology: Topology):
        self.topology = topology
        self.sync_acks: set = set()
        self.synced = False
        self.ready: AsyncResult = AsyncResult()


class TopologyManager:
    def __init__(self, node_id: NodeId):
        self.node_id = node_id
        self._epochs: Dict[int, _EpochState] = {}
        self._current_epoch = 0
        self._awaiting: Dict[int, AsyncResult] = {}

    # -- updates -------------------------------------------------------------
    def on_topology_update(self, topology: Topology, notify: bool = True) -> None:
        e = topology.epoch
        if e in self._epochs:
            return
        Invariants.check_argument(e == self._current_epoch + 1 or self._current_epoch == 0,
                                  "epoch gap: have %s, got %s", self._current_epoch, e)
        st = _EpochState(topology)
        self._epochs[e] = st
        self._current_epoch = max(self._current_epoch, e)
        # epoch 1 (or a single-node cluster) needs no sync from anyone else
        if e == 1:
            st.synced = True
            st.ready.try_set_success(None)
        if notify:
            self.notify_epoch(e)

    def notify_epoch(self, epoch: int) -> None:
        """Fire await_epoch waiters. Node passes notify=False above and calls
        this only AFTER CommandStores.update_topology has applied the epoch's
        ownership: waiter callbacks run synchronously (and the sim scheduler's
        now() is inline), so firing them from on_topology_update would process
        epoch-gated messages against the PREVIOUS epoch's store ownership --
        requests for newly-owned ranges would find no intersecting store and
        be silently dropped (the round-4 'lost in rebuild' residual)."""
        st = self._epochs.get(epoch)
        waiter = self._awaiting.pop(epoch, None)
        if waiter is not None and st is not None:
            waiter.try_set_success(st.topology)

    def on_epoch_sync_complete(self, node: NodeId, epoch: int) -> None:
        """A node reports it has fully synced (applied all prior-epoch state
        relevant to) this epoch."""
        st = self._epochs.get(epoch)
        if st is None or st.synced:
            return
        st.sync_acks.add(node)
        # quorum of every shard in the PRIOR epoch must ack before the new
        # epoch is considered synced (reference: EpochState.syncTracker)
        prev = self._epochs.get(epoch - 1)
        basis = prev.topology if prev is not None else st.topology
        if all(len(st.sync_acks & set(s.nodes)) >= s.slow_path_quorum_size
               for s in basis.shards):
            st.synced = True
            st.ready.try_set_success(None)

    # -- queries -------------------------------------------------------------
    @property
    def epoch(self) -> int:
        return self._current_epoch

    def current(self) -> Topology:
        Invariants.check_state(self._current_epoch > 0, "no topology yet")
        return self._epochs[self._current_epoch].topology

    def for_epoch(self, epoch: int) -> Topology:
        st = self._epochs.get(epoch)
        if st is None and self._epochs and epoch < min(self._epochs):
            # retired epoch: every txn of that epoch is below the universal
            # durability floor (see retire_below), so any probe/recovery for
            # one resolves TRUNCATED -- the oldest retained topology answers
            # for the contact set
            return self._epochs[min(self._epochs)].topology
        Invariants.check_state(st is not None, "unknown epoch %s", epoch)
        return st.topology

    def retire_below(self, epoch: int) -> None:
        """Drop epochs strictly below `epoch` (reference:
        TopologyManager.java:75-131 closed/complete range retirement --
        re-keyed here to the universal durability floor, which subsumes the
        closed-range reasoning: below it nothing can need an old quorum).
        Never drops the current epoch or any epoch the unsynced-window
        extension could still reach."""
        if not self._epochs:
            return
        # keep the newest synced epoch <= every retained unsynced window:
        # with_unsynced_epochs walks DOWN from a coordination's min epoch
        # until it finds a synced one -- that epoch must survive
        keep = min(epoch, self._current_epoch)
        lo = min(self._epochs)
        while keep > lo and not self.is_synced(keep):
            keep -= 1
        for e in [e for e in self._epochs if e < keep]:
            del self._epochs[e]

    def has_epoch(self, epoch: int) -> bool:
        return epoch in self._epochs

    def min_epoch(self) -> int:
        return min(self._epochs) if self._epochs else 0

    def await_epoch(self, epoch: int) -> AsyncResult:
        """Completes once the topology for `epoch` is known locally."""
        if epoch in self._epochs:
            from accord_tpu_torch.utils.async_ import success
            return success(self._epochs[epoch].topology)
        return self._awaiting.setdefault(epoch, AsyncResult())

    def epoch_ready(self, epoch: int) -> AsyncResult:
        st = self._epochs.get(epoch)
        Invariants.check_state(st is not None, "unknown epoch %s", epoch)
        return st.ready

    def is_synced(self, epoch: int) -> bool:
        st = self._epochs.get(epoch)
        return st is not None and st.synced

    # -- the coordination contact-set computations ---------------------------
    def precise_epochs(self, min_epoch: int, max_epoch: int) -> Topologies:
        """Topologies for [min_epoch, max_epoch], newest first (clamped to
        the retained window: retired epochs are answered by the oldest
        retained topology -- see retire_below)."""
        min_epoch = max(min_epoch, self.min_epoch())
        max_epoch = max(max_epoch, min_epoch)   # fully-retired window: the
        # oldest retained topology answers (any such txn is below the
        # universal durability floor, so replies resolve TRUNCATED)
        tops = [self._epochs[e].topology for e in range(max_epoch, min_epoch - 1, -1)]
        return Topologies(tops)

    def with_unsynced_epochs(self, route: Route, min_epoch: int, max_epoch: int) -> Topologies:
        """Epochs [min', max_epoch] where min' extends below min_epoch while
        epochs remain unsynced (so coordinations keep contacting the old
        replica sets until handover quorums complete)."""
        floor = self.min_epoch()
        lo = max(min_epoch, floor)
        while lo > floor and not self.is_synced(lo):
            lo -= 1
        return self.precise_epochs(lo, max_epoch)
