"""Bootstrap data fetch.

Role-equivalent to the reference's DataStore fetch protocol
(api/DataStore.java:39-113: FetchRanges/FetchResult) driven by
AbstractFetchCoordinator's FetchRequest -- itself a ReadData subclass
(impl/AbstractFetchCoordinator.java:60,238): the source replica waits until
the bootstrap's ExclusiveSyncPoint has applied locally (so its snapshot
contains every txn below the floor), then streams the requested ranges.
"""
from __future__ import annotations

from typing import Dict, Tuple

from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.messages.wait import when_locally_applied
from accord_tpu_torch.primitives.keyspace import Ranges
from accord_tpu_torch.primitives.timestamp import TxnId


class FetchData(Request):
    def __init__(self, sync_id: TxnId, scope: Ranges, ranges: Ranges):
        self.sync_id = sync_id     # the bootstrap's ExclusiveSyncPoint
        self.scope = scope         # the sync point's full seekables
        self.ranges = ranges       # the slice this source should stream
        self.wait_for_epoch = sync_id.epoch

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        def respond():
            # a source whose data has a gap over any of these ranges (its
            # bootstrap snapshot never arrived, so its floor elided pre-floor
            # deps without the history being present) must not serve: refuse
            # so the fetcher tries another source (reference: ReadData
            # replies with unavailable ranges)
            for s in node.command_stores.all():
                if s.has_gap(self.ranges):
                    node.reply(from_node, reply_context,
                               FetchNack(self.sync_id, self.ranges))
                    return
            data: Dict[object, Tuple] = {}
            for key, entries in node.data_store.data.items():
                if self.ranges.contains_key(key):
                    data[key] = tuple(entries)
            node.reply(from_node, reply_context,
                       FetchOk(self.sync_id, self.ranges, data))

        when_locally_applied(node, self.sync_id, self.scope, respond)

    def __repr__(self):
        return f"FetchData({self.sync_id!r}, {self.ranges!r})"


class DataRepairRead(Request):
    """Unconditional data read for union repair: serve whatever this node's
    durable data store currently holds for `ranges` -- no gap check, no
    sync-point wait. Used to heal repair_gaps (missing data that is known
    universally applied: every then-replica's data store holds it, and data
    stores only grow, so the union over any set containing one then-replica
    is complete). A gap-checked FetchData cannot heal these: when every
    current replica is itself gapped they nack each other forever."""

    def __init__(self, ranges: Ranges):
        self.ranges = ranges
        self.wait_for_epoch = 0

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        data: Dict[object, Tuple] = {}
        for key, entries in node.data_store.data.items():
            if self.ranges.contains_key(key):
                data[key] = tuple(entries)
        node.reply(from_node, reply_context, DataRepairOk(self.ranges, data))

    def __repr__(self):
        return f"DataRepairRead({self.ranges!r})"


class DataRepairOk(Reply):
    __slots__ = ("ranges", "data")

    def __init__(self, ranges: Ranges, data: Dict[object, Tuple]):
        self.ranges = ranges
        self.data = data

    def __repr__(self):
        return f"DataRepairOk(keys={len(self.data)})"


class FetchNack(Reply):
    """Source cannot serve these ranges right now (its own bootstrap of them
    is incomplete); the fetcher escalates to another source."""

    __slots__ = ("sync_id", "ranges")

    def __init__(self, sync_id: TxnId, ranges: Ranges):
        self.sync_id = sync_id
        self.ranges = ranges

    def __repr__(self):
        return f"FetchNack({self.sync_id!r}, {self.ranges!r})"


class FetchOk(Reply):
    __slots__ = ("sync_id", "ranges", "data")

    def __init__(self, sync_id: TxnId, ranges: Ranges, data: Dict[object, Tuple]):
        self.sync_id = sync_id
        self.ranges = ranges  # which request this answers (a source can hold
        self.data = data      # several outstanding fetches); key -> entries

    def __repr__(self):
        return f"FetchOk({self.sync_id!r}, keys={len(self.data)})"
