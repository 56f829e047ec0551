"""FetchMaxConflict: quorum-read the max witnessed conflict timestamp.

Role-equivalent to the reference's coordinate/FetchMaxConflict.java:44
(sole production caller: Bootstrap's safe-to-read establishment,
local/Bootstrap.java:239). A quorum per shard guarantees the result is at
or above every timestamp any committed conflicting txn can carry: any
commit quorum intersects ours. The reference additionally chases topology
changes via the replies' latestEpoch; here the caller (bootstrap) already
runs inside an epoch transition and retries wholesale on failure, so the
chase is omitted.
"""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.coordinate.errors import Timeout
from accord_tpu_torch.coordinate.tracking import QuorumTracker, RequestStatus
from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.getdeps import GetMaxConflict, MaxConflictOk
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp
from accord_tpu_torch.utils.async_ import AsyncResult


class FetchMaxConflict(Callback):
    def __init__(self, node, seekables: Seekables):
        self.node = node
        self.seekables = seekables
        self.result: AsyncResult = AsyncResult()
        topologies = node.topology_manager.with_unsynced_epochs(
            Route(None, seekables), node.epoch, node.epoch)
        self.tracker = QuorumTracker(topologies, seekables)
        self.max_conflict: Optional[Timestamp] = None

    @classmethod
    def fetch(cls, node, seekables: Seekables) -> AsyncResult:
        """Completes with the max conflict Timestamp (None when no replica
        has witnessed any conflict for the seekables)."""
        self = cls(node, seekables)
        for to in self.tracker.nodes():
            node.send(to, GetMaxConflict(seekables, node.epoch), self)
        return self.result

    def on_success(self, from_node, reply) -> None:
        if self.result.done or not isinstance(reply, MaxConflictOk):
            return
        self.max_conflict = Timestamp.merge_max(self.max_conflict,
                                                reply.max_conflict)
        if self.tracker.on_success(from_node) == RequestStatus.SUCCESS:
            self.result.try_set_success(self.max_conflict)

    def on_failure(self, from_node, failure) -> None:
        if self.result.done:
            return
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self.result.try_set_failure(
                Timeout(f"fetchMaxConflict {self.seekables!r}"))
