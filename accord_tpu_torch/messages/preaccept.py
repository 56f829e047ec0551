"""PreAccept: witness a txn and return (witnessedAt, deps)
(reference: messages/PreAccept.java:37; handler logic :90-156)."""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands
from accord_tpu_torch.local.commands import AcceptOutcome
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn


class PreAccept(Request):
    def __init__(self, txn_id: TxnId, txn: Txn, route: Route,
                 min_epoch: int = 0):
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        # ExtraEpochs re-contact must not process before the recipient has
        # the epoch whose replicas it is addressed to (reference:
        # TxnRequest computes waitForEpoch from the scope epochs)
        self.wait_for_epoch = max(txn_id.epoch, min_epoch)

    def process(self, node, from_node, reply_context) -> None:
        from accord_tpu_torch.utils.async_ import all_of, success

        stores = node.command_stores.intersecting(self.txn.keys)
        if not stores:
            node.reply(from_node, reply_context, None)
            return
        # per-store PreAccept, micro-batched onto the device when a batch
        # resolver is installed (store.submit_preaccept)
        parts = [s.submit_preaccept(
                    self.txn_id, self.txn.slice(s.ranges, include_query=False),
                    self.route)
                 for s in stores]

        def finish(results):
            reply = None
            for outcome, witnessed, deps in results:
                if outcome in (AcceptOutcome.REJECTED_BALLOT,
                               AcceptOutcome.TRUNCATED):
                    reply = PreAcceptNack(self.txn_id)
                    break
                part = PreAcceptOk(self.txn_id, witnessed, deps)
                if reply is None:
                    reply = part
                else:
                    # (reference: PreAcceptOk reduce, messages/PreAccept.java:
                    # 141-156; merge_witnessed keeps one store's rejection
                    # sticky across stores)
                    reply = PreAcceptOk(
                        self.txn_id,
                        Timestamp.merge_witnessed(reply.witnessed_at,
                                                  part.witnessed_at),
                        reply.deps.union(part.deps))
            node.reply(from_node, reply_context, reply)

        all_of(parts).on_success(finish) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"PreAccept({self.txn_id!r})"


class PreAcceptOk(Reply):
    __slots__ = ("txn_id", "witnessed_at", "deps")

    def __init__(self, txn_id: TxnId, witnessed_at: Timestamp, deps: Deps):
        self.txn_id = txn_id
        self.witnessed_at = witnessed_at
        self.deps = deps

    @property
    def is_fast_path_vote(self) -> bool:
        return self.witnessed_at == self.txn_id

    def __repr__(self):
        return f"PreAcceptOk({self.txn_id!r}@{self.witnessed_at!r})"


class PreAcceptNack(Reply):
    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    def __repr__(self):
        return f"PreAcceptNack({self.txn_id!r})"
