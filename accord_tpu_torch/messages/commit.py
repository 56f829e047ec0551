"""Commit(Stable): deliver the final (executeAt, deps) decision; optionally
carries an embedded read to overlap commit with execution
(reference: messages/Commit.java:61, kinds :84 -- our `read` flag is the
reference's StableFastPath-with-ReadData 'stableAndRead')."""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.messages.read import execute_read_when_ready
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn


class Commit(Request):
    def __init__(self, txn_id: TxnId, route: Route, txn: Optional[Txn],
                 execute_at: Timestamp, deps: Deps, read: bool = False):
        self.txn_id = txn_id
        self.route = route
        self.txn = txn
        self.execute_at = execute_at
        self.deps = deps
        self.read = read
        self.wait_for_epoch = max(txn_id.epoch, execute_at.epoch)

    def process(self, node, from_node, reply_context) -> None:
        keys = self.txn.keys

        def map_fn(store):
            partial = self.txn.slice(store.ranges, include_query=False)
            store.commit_op(self.txn_id, self.route, partial,
                            self.execute_at, self.deps)
            return CommitOk(self.txn_id)

        def after(reply):
            if self.read:
                # overlap commit with execution: reply with the read result
                # (committed=True: even a nack is a stable vote, the commit
                # above already processed)
                execute_read_when_ready(node, self.txn_id, self.txn,
                                        self.execute_at, from_node,
                                        reply_context, committed=True)
            else:
                node.reply(from_node, reply_context, reply)

        node.command_stores.map_reduce(keys, map_fn, lambda a, b: a) \
            .on_success(after) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"Commit({self.txn_id!r}@{self.execute_at!r}, read={self.read})"


class CommitOk(Reply):
    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    def __repr__(self):
        return f"CommitOk({self.txn_id!r})"
