"""CoordinateSyncPoint + Barrier.

Role-equivalent to the reference's coordinate/CoordinateSyncPoint.java:58 (+
the sync-point CoordinationAdapters, CoordinationAdapter.java:77-131) and
coordinate/Barrier.java:64. A sync point rides the standard transaction
machinery -- PreAccept / (Accept) / Commit(Stable) / Apply -- with an empty
txn of kind SYNC_POINT or EXCLUSIVE_SYNC_POINT; what differs is only the
adapter policy:

  inclusive (async)    -> complete once stable everywhere; Apply in background
  inclusive (blocking) -> complete once a quorum has applied
  exclusive            -> always run the Accept round (never fast-path
                          straight to execute), complete once stable; the
                          durability/bootstrap machinery later drives
                          ApplyThenWaitUntilApplied against it

The result value is the SyncPoint (syncId, waitFor, ...) rather than a client
Result.
"""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.coordinate.transaction import CoordinateTransaction, _ApplyRound
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.syncpoint import SyncPoint
from accord_tpu_torch.primitives.timestamp import TxnId, TxnKind
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_ import AsyncResult
from accord_tpu_torch.utils.invariants import Invariants


class CoordinateSyncPoint(CoordinateTransaction):
    def __init__(self, node, txn_id: TxnId, txn: Txn, route, blocking: bool):
        super().__init__(node, txn_id, txn, route)
        self.blocking = blocking

    # -- entry points (reference: CoordinateSyncPoint.exclusive/inclusive) ---
    @classmethod
    def exclusive(cls, node, seekables: Seekables,
                  blocking: bool = False) -> AsyncResult:
        """blocking=True completes only once an APPLIED quorum exists per
        shard -- the durability rounds' prerequisite (everything ordered
        below the sync point is then applied at a quorum)."""
        return cls._coordinate(node, TxnKind.EXCLUSIVE_SYNC_POINT, seekables,
                               blocking=blocking)

    @classmethod
    def inclusive(cls, node, seekables: Seekables,
                  blocking: bool = False) -> AsyncResult:
        return cls._coordinate(node, TxnKind.SYNC_POINT, seekables,
                               blocking=blocking)

    @classmethod
    def build(cls, node, kind: TxnKind, seekables: Seekables,
              blocking: bool = False) -> "CoordinateSyncPoint":
        """Create without sending anything: the caller may need the txn_id
        before the first message goes out (Bootstrap sets its floor from it)."""
        txn = node.agent.empty_txn(kind, seekables)
        txn_id = node.next_txn_id(kind, seekables.domain)
        route = node.compute_route(txn)
        return cls(node, txn_id, txn, route, blocking)

    def start(self) -> AsyncResult:
        self._start_preaccept()
        return self.result

    @classmethod
    def _coordinate(cls, node, kind: TxnKind, seekables: Seekables,
                    blocking: bool) -> AsyncResult:
        return cls.build(node, kind, seekables, blocking).start()

    # -- adapter policy overrides -------------------------------------------
    def _on_preaccepted(self, round_) -> None:
        # merge deps from EVERY reply -- the waitFor set must cover everything
        # any contacted replica witnessed (reference:
        # CoordinateSyncPoint.onPreAccepted merges all oks)
        oks = round_.oks.values()
        self.deps = Deps.merge([ok.deps for ok in oks])
        if any(ok.witnessed_at.is_rejected for ok in oks):
            self._invalidate_rejected()
            return
        if round_.tracker.has_fast_path_accepted() \
                and self.txn_id.kind is TxnKind.SYNC_POINT:
            self.execute_at = self.txn_id.as_timestamp()
            self._start_execute()
        else:
            # exclusive sync points always run the Accept round: their deps
            # must be ballot-recoverable before anyone treats lower TxnIds as
            # expired (reference: CoordinateSyncPoint.java:129-133)
            self.execute_at = max(ok.witnessed_at for ok in oks)
            self._start_propose()

    def _persist(self, writes, result) -> None:
        Invariants.check_state(writes is None, "sync point computed writes")
        sp = SyncPoint(self.txn_id, self.route, self.deps, self.txn.keys)
        if self.blocking:
            _ApplyRound(self, None, None,
                        on_applied=lambda: self.result.try_set_success(sp)).start()
        else:
            self.result.try_set_success(sp)
            _ApplyRound(self, None, None).start()


class Barrier:
    """Wait for (at least) everything that happened before the barrier's
    creation to become visible (reference: coordinate/Barrier.java:64).

    local        -> a sync point has applied on THIS node
    global_sync  -> a sync point has applied on a quorum of every shard
    global_async -> a sync point is stable (committed) everywhere
    """

    @staticmethod
    def local(node, seekables: Seekables) -> AsyncResult:
        out: AsyncResult = AsyncResult()

        def on_stable(sp: SyncPoint):
            _await_local_apply(node, sp, out)

        CoordinateSyncPoint.inclusive(node, seekables, blocking=False) \
            .on_success(on_stable) \
            .on_failure(out.try_set_failure)
        return out

    @staticmethod
    def global_sync(node, seekables: Seekables) -> AsyncResult:
        return CoordinateSyncPoint.inclusive(node, seekables, blocking=True)

    @staticmethod
    def global_async(node, seekables: Seekables) -> AsyncResult:
        return CoordinateSyncPoint.inclusive(node, seekables, blocking=False)


def _await_local_apply(node, sp: SyncPoint, out: AsyncResult) -> None:
    """Complete once the sync point has applied on every local store owning
    its seekables (fires immediately when this node owns none of them)."""
    from accord_tpu_torch.messages.wait import when_locally_applied
    when_locally_applied(node, sp.sync_id, sp.seekables,
                         lambda: out.try_set_success(sp))
