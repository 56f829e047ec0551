"""GetDeps: standalone dependency collection (reference:
messages/GetDeps.java) -- ask a replica which witnessed conflicts started
before a given bound. Used by recovery's CollectDeps when no committed deps
cover a shard, and later by sync points. GetMaxConflict (reference:
messages/GetMaxConflict.java) is its timestamp-only sibling."""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class GetDeps(Request):
    def __init__(self, txn_id: TxnId, keys: Seekables, before: Timestamp):
        self.txn_id = txn_id
        self.keys = keys
        self.before = before
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            deps = store.calculate_deps(self.txn_id, store.owned(self.keys),
                                        self.before)
            return GetDepsOk(self.txn_id, deps)

        def reduce_fn(a, b):
            return GetDepsOk(self.txn_id, a.deps.union(b.deps))

        node.command_stores.map_reduce(self.keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"GetDeps({self.txn_id!r} before {self.before!r})"


class GetDepsOk(Reply):
    __slots__ = ("txn_id", "deps")

    def __init__(self, txn_id: TxnId, deps: Deps):
        self.txn_id = txn_id
        self.deps = deps

    def __repr__(self):
        return f"GetDepsOk({self.txn_id!r})"


class GetEphemeralReadDeps(Request):
    """Deps collection for an ephemeral read (reference:
    messages/GetEphemeralReadDeps.java): every witnessed conflict, no
    timestamp bound (the read executes after ALL of them), plus the
    replica's latest epoch so the coordinator can chase topology changes.
    Registers NOTHING: an ephemeral read is invisible to other txns."""

    def __init__(self, txn_id: TxnId, keys: Seekables):
        self.txn_id = txn_id
        self.keys = keys
        self.wait_for_epoch = txn_id.epoch

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            deps = store.calculate_deps(self.txn_id, store.owned(self.keys),
                                        Timestamp.MAX)
            return GetEphemeralReadDepsOk(self.txn_id, deps, node.epoch)

        def reduce_fn(a, b):
            return GetEphemeralReadDepsOk(
                self.txn_id, a.deps.union(b.deps),
                max(a.latest_epoch, b.latest_epoch))

        node.command_stores.map_reduce(self.keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"GetEphemeralReadDeps({self.txn_id!r})"


class GetEphemeralReadDepsOk(Reply):
    __slots__ = ("txn_id", "deps", "latest_epoch")

    def __init__(self, txn_id: TxnId, deps: Deps, latest_epoch: int):
        self.txn_id = txn_id
        self.deps = deps
        self.latest_epoch = latest_epoch

    def __repr__(self):
        return f"GetEphemeralReadDepsOk({self.txn_id!r}, epoch={self.latest_epoch})"


class GetMaxConflict(Request):
    """Max witnessed conflict timestamp over some keys/ranges (reference:
    messages/GetMaxConflict.java): the timestamp-only sibling of GetDeps.
    Used by bootstrap to seed a freshly-acquired range's conflict registry
    (the snapshot carries data, not conflict history)."""

    def __init__(self, keys: Seekables, min_epoch: int = 0):
        self.keys = keys
        self.wait_for_epoch = min_epoch

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            ts = store.max_conflict_ts(store.owned(self.keys))
            return MaxConflictOk(ts, node.epoch)

        def reduce_fn(a, b):
            return MaxConflictOk(Timestamp.merge_max(a.max_conflict,
                                                     b.max_conflict),
                                 max(a.latest_epoch, b.latest_epoch))

        node.command_stores.map_reduce(self.keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(
                from_node, reply_context,
                reply if reply is not None else MaxConflictOk(None, node.epoch))) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"GetMaxConflict({self.keys!r})"


class MaxConflictOk(Reply):
    __slots__ = ("max_conflict", "latest_epoch")

    def __init__(self, max_conflict: Optional[Timestamp], latest_epoch: int):
        self.max_conflict = max_conflict
        self.latest_epoch = latest_epoch

    def __repr__(self):
        return f"MaxConflictOk({self.max_conflict!r})"
