"""Propagate: apply remotely-learned knowledge to the local stores.

Role-equivalent to the reference's Propagate LocalRequest (messages/
Propagate.java:64): when a CheckStatus probe (MaybeRecover) learns an
outcome / invalidation / truncation, the LOCAL application of that knowledge
is itself a side-effecting message -- routed through Node.receive_local so
the host's journal records it (the reference flags Propagate* in MessageType
as hasSideEffects for exactly this reason). Without this, state repaired
locally by a probe is invisible to journal replay and a restart rebuilds the
command only to NOT_DEFINED.
"""
from __future__ import annotations

from typing import List, Optional

from accord_tpu_torch.messages.base import Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import TxnId


def _scope(merged, participants) -> Seekables:
    if merged is not None and merged.route is not None:
        return merged.route.participants
    return participants


def covering_stores(node, txn_id: TxnId, participants, merged) -> List:
    """The local stores whose slice of the participants the merged knowledge
    fully covers (definition AND -- for writes -- the writes themselves).
    Shared by the MaybeRecover decision (apply vs re-execute) and the
    Propagate application so the two can never diverge."""
    out = []
    scope = _scope(merged, participants)
    for store in node.command_stores.all():
        if not store.owns(scope):
            continue
        need = store.owned(scope).to_ranges()
        if merged.partial_txn is None or not merged.partial_txn.covers(need):
            continue
        w = merged.writes
        if txn_id.kind.is_write:
            # writes union from FEWER replies than partial_txn (STABLE
            # replies carry txn but no writes): applying a narrower writes
            # slice while marking APPLIED would silently lose writes for the
            # uncovered keys
            if w is None:
                continue
            needed_keys = set(merged.partial_txn.keys.slice(need))
            if not needed_keys <= set(w.keys):
                continue
        out.append(store)
    return out


def apply_outcome(node, txn_id: TxnId, participants, merged) -> None:
    from accord_tpu_torch.local import commands
    w = merged.writes
    for store in covering_stores(node, txn_id, participants, merged):
        partial = merged.partial_txn.slice(store.ranges, include_query=False)
        deps = (merged.stable_deps or Deps.NONE).slice(store.ranges)
        commands.apply(store, txn_id, merged.route,
                       partial, merged.execute_at, deps,
                       w.slice(store.ranges) if w is not None else None,
                       merged.result)


def apply_invalidate(node, txn_id: TxnId, participants, merged) -> None:
    from accord_tpu_torch.local import commands
    scope = _scope(merged, participants)
    for store in node.command_stores.all():
        if store.owns(scope) or store.owns(participants):
            commands.commit_invalidate(store, txn_id)


def mark_local_truncated(node, txn_id: TxnId, scope) -> None:
    """The outcome is durable cluster-wide but no reachable reply carries it
    any more (or a local copy can no longer accept it): mark local records
    truncated (dependents drop the edge); a replica that never applied a
    truncated WRITE gets a repair gap -- its data heals by union data
    repair. Records at PRE_APPLIED+ keep going: they hold the outcome and
    finish locally on their own."""
    from accord_tpu_torch.local import commands as _commands
    from accord_tpu_torch.local.status import Status as _S
    for store in node.command_stores.all():
        if not store.owns(scope):
            continue
        # create the record if absent: the engine (and any future waiter
        # resurrecting the id) needs the terminal status to be LOCALLY
        # visible, else it re-probes a cluster-wide truncation forever
        cmd = store.command(txn_id)
        if cmd.status.is_terminal or cmd.has_been(_S.PRE_APPLIED):
            continue
        if txn_id.kind.is_write \
                and not store.bootstrap_covers(txn_id, scope) \
                and store.current_owned().intersects(scope):
            # a truncated WRITE this store never applied and no snapshot
            # delivered: mark ONLY the currently-owned slice (gap-marking
            # ranges the store merely lost would poison historical serving
            # forever -- nothing repairs a range the store no longer owns)
            gap = store.owned(scope).to_ranges().intersection(
                store.current_owned())
            store.mark_repair_gap(gap)
        cmd.status = _S.TRUNCATED
        _commands.notify_listeners(store, cmd)
        store.progress_log.clear(txn_id)


class Propagate(Request):
    """LocalRequest applying learned knowledge; journaled via receive_local."""

    OUTCOME = "outcome"
    INVALIDATE = "invalidate"
    TRUNCATE = "truncate"

    def __init__(self, kind: str, txn_id: TxnId, participants: Seekables,
                 merged=None):
        self.kind = kind
        self.txn_id = txn_id
        self.participants = participants
        self.merged = merged  # CheckStatusOk (None for a bare truncation)
        self.wait_for_epoch = txn_id.epoch

    @property
    def has_side_effects(self) -> bool:
        return True

    def process(self, node, from_node, reply_context) -> None:
        if self.kind == Propagate.INVALIDATE:
            apply_invalidate(node, self.txn_id, self.participants, self.merged)
        elif self.kind == Propagate.TRUNCATE:
            mark_local_truncated(node, self.txn_id,
                                 _scope(self.merged, self.participants))
        else:
            from accord_tpu_torch.local.status import Status as _S
            apply_outcome(node, self.txn_id, self.participants, self.merged)
            if self.merged is not None and self.merged.status == _S.TRUNCATED:
                # the remote world truncated this txn: a local copy that
                # could not accept the outcome (commands.apply refuses any
                # record with a participant below the truncation horizon)
                # must still terminate, or its tracker probes forever --
                # stores where the apply DID land are at PRE_APPLIED+ and
                # are left to finish on their own
                mark_local_truncated(node, self.txn_id,
                                     _scope(self.merged, self.participants))

    def __repr__(self):
        return f"Propagate({self.kind}, {self.txn_id!r})"
