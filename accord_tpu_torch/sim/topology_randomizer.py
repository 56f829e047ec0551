"""Random topology churn for the burn test.

Role-equivalent to the reference's TopologyRandomizer (test
topology/TopologyRandomizer.java:60): every simulated interval, mutate the
cluster topology — move a replica, split a shard, or merge two adjacent
shards — and publish the result as the next epoch. The burn test runs this
concurrently with the workload so epoch handover, bootstrap/fetch and
unsynced-epoch contact sets are exercised under load.

All randomness comes from a forked RandomSource and all scheduling rides the
cluster's PendingQueue, so churn is fully deterministic per seed.
"""
from __future__ import annotations

from typing import List, Optional

from accord_tpu_torch.primitives.keyspace import Range
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology


class TopologyRandomizer:
    def __init__(self, cluster, rng, *, interval_us: int = 1_000_000,
                 min_shards: int = 2, max_shards: int = 8,
                 max_epochs: Optional[int] = None, should_stop=None,
                 max_pending: int = 3):
        self.cluster = cluster
        self.rng = rng
        self.interval_us = interval_us
        self.min_shards = min_shards
        self.max_shards = max_shards
        self.max_epochs = max_epochs  # stop after this many issued epochs
        self.should_stop = should_stop  # extra predicate checked each tick
        # backpressure (reference: TopologyRandomizer.maybeUpdateTopology
        # skips when pendingTopologies() > 5): unbounded in-flight epochs
        # pile bootstraps on bootstraps until no replica holds a complete
        # copy of a range and every fetch deadlocks
        self.max_pending = max_pending
        self.issued = 0
        self.mutation_counts: dict = {}  # mutation name -> times applied
        self.stopped = False
        # low-water mark: epochs below this are synced at every node (sync
        # is permanent, so the mark only moves forward -- keeps the per-tick
        # pending scan O(pending), not O(total epochs))
        self._synced_floor = 2

    def start(self) -> None:
        self.cluster.queue.add(self.interval_us, self._tick)

    def stop(self) -> None:
        self.stopped = True

    # -- mutations ------------------------------------------------------------
    def _tick(self) -> None:
        if self.should_stop is not None and self.should_stop():
            self.stopped = True
        if self.stopped or (self.max_epochs is not None
                            and self.issued >= self.max_epochs):
            return
        if self._pending_epochs() <= self.max_pending:
            current = self.cluster.current_topology()
            mutated = self._mutate(current)
            if mutated is not None:
                self.issued += 1
                self.cluster.issue_topology(mutated)
        self.cluster.queue.add(self.interval_us, self._tick)

    def _pending_epochs(self) -> int:
        """Epochs issued but not yet synced at every node that knows them,
        PLUS any outstanding bootstrap anywhere (an aborted bootstrap acks
        its epoch even though the node's data is still gapped, so sync state
        alone undercounts; issuing epochs faster than snapshots arrive can
        leave NO replica with a complete copy of a range -- an unrecoverable
        fetch deadlock)."""
        for n in self.cluster.nodes.values():
            for s in n.command_stores.all():
                # only gaps on CURRENTLY-OWNED ranges matter: those stores
                # are the next epoch's fetch sources and must be complete
                # first (they self-heal via the progress engine). A gap on a
                # range the store merely lost never blocks -- it can only
                # heal through a re-add this very randomizer would issue.
                if not s.data_gaps.intersection(s.current_owned()).is_empty() \
                        or s.active_bootstraps:
                    return self.max_pending + 1
        svc = self.cluster.topology_service
        latest = max(svc.epochs)
        # delivery skew: a node that has not RECEIVED the latest epoch has
        # not started its bootstraps yet, so the gap check above cannot see
        # them -- mutating now could remove a range mid-acquisition and leave
        # a permanent data gap (no replica with a complete copy = wedged)
        for nid in self.cluster.nodes:
            if svc.delivered_epoch(nid) < latest:
                return self.max_pending + 1
        while self._synced_floor <= latest and all(
                n.topology_manager.is_synced(self._synced_floor)
                for n in self.cluster.nodes.values()):
            self._synced_floor += 1
        pending = 0
        for e in range(self._synced_floor, latest + 1):
            if any(not n.topology_manager.is_synced(e)
                   for n in self.cluster.nodes.values()):
                pending += 1
        return pending

    def _mutate(self, t: Topology) -> Optional[Topology]:
        choices = [self._move, self._electorate, self._bounce_node]
        if len(t.shards) < self.max_shards:
            choices.append(self._split)
        if len(t.shards) > self.min_shards:
            choices.append(self._merge)
        mutation = self.rng.pick(choices)
        shards = mutation(list(t.shards))
        if shards is None:
            return None
        name = mutation.__name__.lstrip("_")
        self.mutation_counts[name] = self.mutation_counts.get(name, 0) + 1
        return Topology(t.epoch + 1, shards)

    def _move(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Replace one replica of a random shard with a node outside it."""
        i = self.rng.next_int(len(shards))
        s = shards[i]
        all_nodes = sorted(self.cluster.nodes)
        spare = [n for n in all_nodes if n not in s.nodes]
        if not spare:
            return None
        incoming = self.rng.pick(spare)
        outgoing = self.rng.pick(list(s.nodes))
        nodes = sorted(set(s.nodes) - {outgoing} | {incoming})
        shards[i] = Shard(s.range, nodes)
        return shards

    def _split(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Split a random shard's range at a random interior point; both
        halves keep the replica set (no bootstrap needed)."""
        candidates = [i for i, s in enumerate(shards)
                      if s.range.end - s.range.start >= 2]
        if not candidates:
            return None
        i = self.rng.pick(candidates)
        s = shards[i]
        at = s.range.start + 1 + self.rng.next_int(s.range.end - s.range.start - 1)
        shards[i:i + 1] = [Shard(Range(s.range.start, at), s.nodes),
                           Shard(Range(at, s.range.end), s.nodes)]
        return shards

    def _electorate(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Mutate a shard's fast-path electorate and joining set (reference:
        TopologyRandomizer.updateFastPathElectorate/markJoining,
        test topology/TopologyRandomizer.java:430): shrink the electorate to
        a random legal subset; excluded replicas are marked `joining` half
        the time (a replica still syncing data votes no fast path)."""
        # a draw can reproduce the existing shard (e.g. the full electorate
        # again); retry a few times so an electorate mutation reliably lands
        # when one is possible
        for _ in range(8):
            i = self.rng.next_int(len(shards))
            s = shards[i]
            rf = len(s.nodes)
            min_e = rf - (rf - 1) // 2
            size = min_e + self.rng.next_int(rf - min_e + 1)
            members = list(s.nodes)
            # deterministic shuffle via indexed picks
            electorate = set()
            while len(electorate) < size:
                electorate.add(members[self.rng.next_int(rf)])
            excluded = [n for n in s.nodes if n not in electorate]
            joining = frozenset(n for n in excluded if self.rng.decide(0.5))
            new = Shard(s.range, s.nodes, frozenset(electorate), joining)
            if new != s:
                shards[i] = new
                return shards
        return None

    def _bounce_node(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Remove one node from EVERY shard it replicates (the reference's
        node bounce), substituting a spare replica where one exists -- the
        substitute must bootstrap the ranges the victim held. The victim
        stays a live process and re-enters via later move/merge mutations."""
        all_nodes = sorted(self.cluster.nodes)
        present = sorted({n for s in shards for n in s.nodes})
        if not present:
            return None
        victim = self.rng.pick(present)
        changed = False
        for i, s in enumerate(shards):
            if victim not in s.nodes:
                continue
            nodes = set(s.nodes) - {victim}
            spare = [n for n in all_nodes if n not in s.nodes]
            if spare:
                nodes.add(self.rng.pick(spare))
            elif not nodes:
                return None  # single-replica shard with no substitute
            shards[i] = Shard(s.range, sorted(nodes))
            changed = True
        return shards if changed else None

    def _merge(self, shards: List[Shard]) -> Optional[List[Shard]]:
        """Merge two adjacent shards; the merged shard takes one side's
        replica set, so the survivors bootstrap the half they did not own."""
        candidates = [i for i in range(len(shards) - 1)
                      if shards[i].range.end == shards[i + 1].range.start]
        if not candidates:
            return None
        i = self.rng.pick(candidates)
        a, b = shards[i], shards[i + 1]
        nodes = self.rng.pick([a, b]).nodes
        shards[i:i + 2] = [Shard(Range(a.range.start, b.range.end), nodes)]
        return shards
