"""Quorum trackers: per-shard x per-epoch response accounting.

Role-equivalent to the reference's coordinate/tracking package
(AbstractTracker.java:37, QuorumTracker.java:27, FastPathTracker.java:34,
ReadTracker.java:40, AppliedTracker.java:29). A coordination round sends one
request per node; each response is credited to EVERY (epoch, shard) the node
replicates, and the round completes when every shard in every spanned epoch
reaches its criterion.
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple

from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topologies import Topologies
from accord_tpu_torch.utils.invariants import Invariants


class RequestStatus(enum.Enum):
    NO_CHANGE = "no_change"
    SUCCESS = "success"
    FAILED = "failed"


class _ShardState:
    __slots__ = ("shard", "successes", "failures", "fast_votes", "fast_rejects")

    def __init__(self, shard: Shard):
        self.shard = shard
        self.successes: Set[NodeId] = set()
        self.failures: Set[NodeId] = set()
        self.fast_votes: Set[NodeId] = set()
        self.fast_rejects: Set[NodeId] = set()  # electorate members voting non-fast or failed

    # -- slow/classic quorum -------------------------------------------------
    def has_quorum(self) -> bool:
        return len(self.successes) >= self.shard.slow_path_quorum_size

    def has_failed(self) -> bool:
        return len(self.failures) > self.shard.max_failures

    # -- fast path -----------------------------------------------------------
    def fast_achieved(self) -> bool:
        return len(self.fast_votes) >= self.shard.fast_path_quorum_size

    def fast_impossible(self) -> bool:
        e = self.shard.fast_path_electorate
        pending = len(e) - len(self.fast_votes) - len(self.fast_rejects & e)
        return len(self.fast_votes) + pending < self.shard.fast_path_quorum_size

    def fast_resolved(self) -> bool:
        return self.fast_achieved() or self.fast_impossible()


class AbstractTracker:
    def __init__(self, topologies: Topologies, seekables: Optional[Seekables] = None):
        self.topologies = topologies
        self.shards: List[_ShardState] = []
        self._by_node: Dict[NodeId, List[_ShardState]] = {}
        for topology in topologies:
            shards = (topology.shards_for(seekables) if seekables is not None
                      else topology.shards)
            for shard in shards:
                st = _ShardState(shard)
                self.shards.append(st)
                for n in shard.nodes:
                    self._by_node.setdefault(n, []).append(st)
        Invariants.check_state(bool(self.shards), "tracker over zero shards")
        self._decided: Optional[RequestStatus] = None

    def nodes(self) -> Tuple[NodeId, ...]:
        return tuple(sorted(self._by_node))

    def _decide(self) -> RequestStatus:
        if self._decided is not None:
            return RequestStatus.NO_CHANGE
        if any(s.has_failed() for s in self.shards):
            self._decided = RequestStatus.FAILED
            return RequestStatus.FAILED
        if self._is_success():
            self._decided = RequestStatus.SUCCESS
            return RequestStatus.SUCCESS
        return RequestStatus.NO_CHANGE

    def _is_success(self) -> bool:
        raise NotImplementedError

    @property
    def decided(self) -> Optional[RequestStatus]:
        return self._decided

    def on_failure(self, node: NodeId) -> RequestStatus:
        for st in self._by_node.get(node, ()):
            st.failures.add(node)
            if node in st.shard.fast_path_electorate:
                st.fast_rejects.add(node)
        return self._decide()


class QuorumTracker(AbstractTracker):
    """Simple majority in every shard of every epoch."""

    def on_success(self, node: NodeId) -> RequestStatus:
        for st in self._by_node.get(node, ()):
            st.successes.add(node)
        return self._decide()

    def _is_success(self) -> bool:
        return all(s.has_quorum() for s in self.shards)


class FastPathTracker(AbstractTracker):
    """Tracks slow quorum and the fast-path electorate simultaneously
    (reference: FastPathTracker.java:34): success requires a quorum everywhere
    AND the fast path either achieved or ruled out everywhere, so the
    coordinator never commits slow-path while fast was still possible."""

    def on_success(self, node: NodeId, fast_vote: bool) -> RequestStatus:
        for st in self._by_node.get(node, ()):
            st.successes.add(node)
            if node in st.shard.fast_path_electorate:
                (st.fast_votes if fast_vote else st.fast_rejects).add(node)
        return self._decide()

    def _is_success(self) -> bool:
        return all(s.has_quorum() and s.fast_resolved() for s in self.shards)

    def has_fast_path_accepted(self) -> bool:
        return all(s.fast_achieved() for s in self.shards)


class ReadTracker(AbstractTracker):
    """Data quorum: one successful read covering every shard, escalating to
    further replicas on failure (reference: ReadTracker.java:40 trySendMore)."""

    def __init__(self, topologies: Topologies, seekables: Optional[Seekables] = None):
        super().__init__(topologies, seekables)
        self._contacted: Set[NodeId] = set()
        self._data: Set[int] = set()  # indexes of shards with data

    def initial_contacts(self, prefer: Optional[NodeId] = None) -> Tuple[NodeId, ...]:
        """Pick one replica per shard (deduplicated), preferring `prefer`."""
        chosen: Set[NodeId] = set()
        for i, st in enumerate(self.shards):
            if any(n in chosen for n in st.shard.nodes):
                continue
            if prefer is not None and prefer in st.shard.nodes:
                chosen.add(prefer)
            else:
                chosen.add(st.shard.nodes[0])
        self._contacted.update(chosen)
        return tuple(sorted(chosen))

    def on_data_success(self, node: NodeId) -> RequestStatus:
        for i, st in enumerate(self.shards):
            if node in st.shard.nodes:
                st.successes.add(node)
                self._data.add(i)
        return self._decide()

    def on_partial_data(self, node: NodeId,
                        unavailable) -> Tuple[RequestStatus, Tuple[NodeId, ...]]:
        """A reply served SOME slices and reported others unavailable
        (reference: ReadData replies carry `unavailable` ranges): credit the
        shards the reply covered, escalate the rest to further replicas.
        `unavailable` is a Ranges."""
        from accord_tpu_torch.primitives.keyspace import Ranges
        for i, st in enumerate(self.shards):
            if node not in st.shard.nodes or i in self._data:
                # a shard with data already cannot be failed retroactively:
                # later replicas' unrelated gaps must not flip a satisfied
                # shard (and with it the whole round) to FAILED
                continue
            if unavailable.intersects(Ranges([st.shard.range])):
                st.failures.add(node)
            else:
                st.successes.add(node)
                self._data.add(i)
        return self._escalate(node)

    def on_read_failure(self, node: NodeId) -> Tuple[RequestStatus, Tuple[NodeId, ...]]:
        """Returns (status, additional nodes to contact)."""
        for st in self._by_node.get(node, ()):
            st.failures.add(node)
        return self._escalate(node)

    def _escalate(self, node: NodeId) -> Tuple[RequestStatus, Tuple[NodeId, ...]]:
        more: Set[NodeId] = set()
        for i, st in enumerate(self.shards):
            if i in self._data or node not in st.shard.nodes:
                continue
            candidates = [n for n in st.shard.nodes if n not in self._contacted]
            if candidates:
                more.add(candidates[0])
            elif all(n in self._contacted for n in st.shard.nodes) and \
                    not any(n not in st.failures for n in st.shard.nodes if n in self._contacted):
                self._decided = RequestStatus.FAILED
                return RequestStatus.FAILED, ()
        self._contacted.update(more)
        return self._decide(), tuple(sorted(more))

    def _is_success(self) -> bool:
        return len(self._data) == len(self.shards)


class RecoveryTracker(AbstractTracker):
    """Quorum per shard, additionally counting fast-path-electorate members
    whose witnessed timestamp differs from txnId (reference:
    RecoveryTracker.java:26): once more electorate members reject than the
    electorate could spare, the original fast path provably never happened."""

    def on_success(self, node: NodeId, fast_path_vote: bool) -> RequestStatus:
        for st in self._by_node.get(node, ()):
            st.successes.add(node)
            if not fast_path_vote and node in st.shard.fast_path_electorate:
                st.fast_rejects.add(node)
        return self._decide()

    def _is_success(self) -> bool:
        return all(s.has_quorum() for s in self.shards)

    def rejects_fast_path(self) -> bool:
        # only POSITIVE rejects count: a failed/timed-out electorate member
        # (added to fast_rejects by on_failure) proves nothing about the
        # original fast path, so exclude failures from the impossibility math
        return any(
            st.shard.rejects_fast_path(
                len((st.fast_rejects & st.shard.fast_path_electorate) - st.failures))
            for st in self.shards)


class InvalidationTracker(FastPathTracker):
    """Accounting for a BeginInvalidation prepare round (reference:
    InvalidationTracker.java:28): tracks the promise quorum across every
    spanned epoch (vote accounting shared with FastPathTracker), plus the
    fast-path rejection arithmetic -- scoped to the txn's ORIGINAL epoch,
    where any ballot-0 fast quorum must have formed -- that decides whether
    the original fast path is decisively dead (safe to invalidate) or still
    arithmetically possible (must recover instead)."""

    def __init__(self, topologies: Topologies, seekables: Seekables,
                 fast_path_epoch: int):
        super().__init__(topologies, seekables)
        self._fast_states: List[_ShardState] = []
        i = 0
        for topology in topologies:
            shards = topology.shards_for(seekables)
            for _ in shards:
                if topology.epoch == fast_path_epoch:
                    self._fast_states.append(self.shards[i])
                i += 1

    def _is_success(self) -> bool:
        # unlike the parent, invalidation needs only the promise quorum;
        # fast-path resolution is consulted separately via
        # is_fast_path_rejected once every reachable reply is in
        return all(s.has_quorum() for s in self.shards)

    def is_fast_path_rejected(self) -> bool:
        """More REPLIED electorate members cast no ballot-0 fast vote than
        the electorate can spare: no fast quorum ever formed, and our
        promises gate any future vote (reference: isFastPathRejected).
        Failed members prove nothing and are excluded. ANY shard rejecting
        decides: a ballot-0 fast commit needs a fast quorum in EVERY shard,
        so one decisively dead shard kills the whole fast path (reference
        InvalidationTracker sets rejectsFastPath per-shard; the all() this
        replaces was equivalent only while propose_invalidate stayed
        single-key/single-shard)."""
        if not self._fast_states:
            return False
        return any(
            st.shard.rejects_fast_path(
                len((st.fast_rejects & st.shard.fast_path_electorate)
                    - st.failures))
            for st in self._fast_states)


class AppliedTracker(QuorumTracker):
    """Quorum of Apply acks per shard (durability tracking)."""
