"""Apply: persist the outcome (writes + result) on every replica
(reference: messages/Apply.java:47; we always ship txn+deps, i.e. the
reference's Maximal variant -- the Minimal optimization can come once the
journal/durability milestone lands)."""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.primitives.writes import Writes


class Apply(Request):
    def __init__(self, txn_id: TxnId, route: Route, txn: Txn,
                 execute_at: Timestamp, deps: Deps,
                 writes: Optional[Writes], result):
        self.txn_id = txn_id
        self.route = route
        self.txn = txn
        self.execute_at = execute_at
        self.deps = deps
        self.writes = writes
        self.result = result
        self.wait_for_epoch = max(txn_id.epoch, execute_at.epoch)

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            partial = self.txn.slice(store.ranges, include_query=False)
            store.apply_op(self.txn_id, self.route, partial,
                           self.execute_at, self.deps,
                           self.writes.slice(store.ranges) if self.writes else None,
                           self.result)
            return ApplyOk(self.txn_id)

        node.command_stores.map_reduce(self.txn.keys, map_fn, lambda a, b: a) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"Apply({self.txn_id!r}@{self.execute_at!r})"


class ApplyOk(Reply):
    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    def __repr__(self):
        return f"ApplyOk({self.txn_id!r})"
