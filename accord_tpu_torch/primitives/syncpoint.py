"""SyncPoint: the outcome of a sync-point coordination.

Role-equivalent to the reference's primitives/SyncPoint.java: the agreed
(syncId, waitFor deps, keysOrRanges, route) tuple. A sync point is a
transaction with no read/write whose only job is to capture, as of its id,
every conflicting transaction that may execute before (or, for exclusive
sync points, at any time around) it -- the building block for barriers,
durability rounds and bootstrap floors.
"""
from __future__ import annotations

from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import TxnId


class SyncPoint:
    __slots__ = ("sync_id", "route", "wait_for", "seekables")

    def __init__(self, sync_id: TxnId, route: Route, wait_for: Deps,
                 seekables: Seekables):
        self.sync_id = sync_id
        self.route = route
        self.wait_for = wait_for  # deps the sync point gates on
        self.seekables = seekables

    def __repr__(self):
        return (f"SyncPoint({self.sync_id!r}, "
                f"{len(self.wait_for.all_txn_ids())} deps over {self.seekables!r})")
