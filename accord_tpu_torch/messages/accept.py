"""Accept: ballot-protected slow-path executeAt proposal; returns deps up to
executeAt so the coordinator can commit with a complete dep set
(reference: messages/Accept.java:50)."""
from __future__ import annotations

from accord_tpu_torch.local import commands
from accord_tpu_torch.local.commands import AcceptOutcome
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId


class Accept(Request):
    def __init__(self, txn_id: TxnId, ballot: Ballot, route: Route,
                 keys: Seekables, execute_at: Timestamp,
                 deps: Deps = Deps.NONE):
        self.txn_id = txn_id
        self.ballot = ballot
        self.route = route
        self.keys = keys
        self.execute_at = execute_at
        self.deps = deps  # the coordinator's proposal; retained for recovery
        self.wait_for_epoch = max(txn_id.epoch, execute_at.epoch)

    def process(self, node, from_node, reply_context) -> None:
        from accord_tpu_torch.utils.async_ import all_of, success

        stores = node.command_stores.intersecting(self.keys)
        if not stores:
            node.reply(from_node, reply_context, None)
            return

        def one_store(store):
            outcome = store.accept_op(self.txn_id, self.ballot, self.route,
                                      store.owned(self.keys), self.execute_at,
                                      self.deps)
            if outcome == AcceptOutcome.REJECTED_BALLOT:
                return success(AcceptNack(self.txn_id,
                                          store.command(self.txn_id).promised))
            if outcome == AcceptOutcome.TRUNCATED:
                return success(AcceptNack(self.txn_id, None))
            if outcome == AcceptOutcome.REDUNDANT:
                # the txn is already COMMITTED here (a recovery superseded
                # this proposal): answering AcceptOk would let a stale
                # coordinator commit ITS executeAt over the decided one and
                # hand its client a divergent result (observed as the burn's
                # own-write violation) -- report the decision instead
                cmd = store.command(self.txn_id)
                return success(AcceptRedundant(self.txn_id, cmd.execute_at))
            # deps up to executeAt, micro-batched onto the device tick
            return store.calculate_deps_async(
                self.txn_id, store.owned(self.keys), self.execute_at) \
                .map(lambda deps: AcceptOk(self.txn_id, deps))

        def finish(parts):
            reply = None
            for part in parts:
                if isinstance(part, (AcceptNack, AcceptRedundant)):
                    reply = part
                    break
                reply = part if reply is None \
                    else AcceptOk(self.txn_id, reply.deps.union(part.deps))
            node.reply(from_node, reply_context, reply)

        all_of([one_store(s) for s in stores]).on_success(finish) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"Accept({self.txn_id!r}@{self.execute_at!r}, ballot={self.ballot!r})"


class AcceptOk(Reply):
    __slots__ = ("txn_id", "deps")

    def __init__(self, txn_id: TxnId, deps: Deps):
        self.txn_id = txn_id
        self.deps = deps

    def __repr__(self):
        return f"AcceptOk({self.txn_id!r})"


class AcceptNack(Reply):
    __slots__ = ("txn_id", "promised")

    def __init__(self, txn_id: TxnId, promised):
        self.txn_id = txn_id
        self.promised = promised

    def __repr__(self):
        return f"AcceptNack({self.txn_id!r}, promised={self.promised!r})"


class AcceptRedundant(Reply):
    """The txn was already committed (at `execute_at`) when this proposal
    arrived: the proposer must not commit its own executeAt (reference:
    AcceptReply.Redundant carrying the superseding decision)."""

    __slots__ = ("txn_id", "execute_at")

    def __init__(self, txn_id: TxnId, execute_at):
        self.txn_id = txn_id
        self.execute_at = execute_at

    def __repr__(self):
        return f"AcceptRedundant({self.txn_id!r}@{self.execute_at!r})"
