"""Await-execution messages.

Role-equivalent to the reference's ReadData subclasses WaitUntilApplied.java
and ApplyThenWaitUntilApplied.java (messages/ReadData.java:61-90): wait until
a txn has fully applied on every local store owning the given scope, then
reply. ApplyThenWaitUntilApplied additionally carries the full decision
(txn + deps + outcome) so a replica that never learned the txn can apply it
first -- the durability rounds and bootstrap drive sync points to ground with
it.
"""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.local import commands
from accord_tpu_torch.local.command import TransientListener
from accord_tpu_torch.local.status import Status
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn


class AppliedOk(Reply):
    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    def __repr__(self):
        return f"AppliedOk({self.txn_id!r})"


class _AppliedWaiter(TransientListener):
    def __init__(self, done):
        self.done = done
        self.fired = False

    def on_change(self, store, command) -> None:
        if self.fired:
            return
        if command.has_been(Status.APPLIED) or command.status.is_terminal:
            self.fired = True
            command.remove_transient_listener(self)
            self.done()


def when_locally_applied(node, txn_id: TxnId, scope: Seekables, done) -> None:
    """Invoke `done()` once txn_id has applied (or gone terminal) on every
    local store owning `scope`; fires immediately when this node owns none of
    it. Registers with the progress log so a stuck dependency chain gets
    recovered rather than waited on forever."""
    stores = [s for s in node.command_stores.all() if s.owns(scope)]
    if not stores:
        done()
        return
    state = {"remaining": len(stores)}

    def one_done():
        state["remaining"] -= 1
        if state["remaining"] == 0:
            done()

    for store in stores:
        cmd = store.command(txn_id)
        if cmd.has_been(Status.APPLIED) or cmd.status.is_terminal:
            one_done()
        else:
            cmd.add_transient_listener(_AppliedWaiter(one_done))
            # liveness: if the awaited txn (or its deps) is stuck, the
            # progress machinery must drive its recovery
            store.progress_log.waiting(txn_id, Status.APPLIED, scope)


def _reply_when_applied(node, txn_id: TxnId, scope: Seekables,
                        from_node, reply_context) -> None:
    when_locally_applied(
        node, txn_id, scope,
        lambda: node.reply(from_node, reply_context, AppliedOk(txn_id)))


class WaitUntilApplied(Request):
    """(reference: messages/WaitUntilApplied.java)"""

    def __init__(self, txn_id: TxnId, scope: Seekables):
        self.txn_id = txn_id
        self.scope = scope
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        _reply_when_applied(node, self.txn_id, self.scope, from_node, reply_context)

    def __repr__(self):
        return f"WaitUntilApplied({self.txn_id!r})"


class ApplyThenWaitUntilApplied(Request):
    """Apply the carried decision (Maximal Apply: full txn + deps + outcome),
    then reply once it has fully applied locally (reference:
    messages/ApplyThenWaitUntilApplied.java; sync-point grounding via
    CoordinateSyncPoint.sendApply)."""

    def __init__(self, txn_id: TxnId, route: Route, txn: Txn,
                 execute_at: Timestamp, deps: Deps):
        self.txn_id = txn_id
        self.route = route
        self.txn = txn
        self.execute_at = execute_at
        self.deps = deps
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            partial = self.txn.slice(store.ranges, include_query=False)
            commands.apply(store, self.txn_id, self.route, partial,
                           self.execute_at, self.deps, None, None)
            return True

        def after(_):
            _reply_when_applied(node, self.txn_id, self.txn.keys,
                                from_node, reply_context)

        node.command_stores.map_reduce(self.txn.keys, map_fn, lambda a, b: a) \
            .on_success(after) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"ApplyThenWaitUntilApplied({self.txn_id!r})"
