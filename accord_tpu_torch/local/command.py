"""Per-transaction replica-local state.

Role-equivalent to the reference's Command (local/Command.java:77) and its
WaitingOn bitsets (:1224). The reference models each phase as an immutable
subclass; we use one mutable record guarded by the single-threaded store
discipline (exactly the reference's threading model, minus the class
ceremony), with transitions funneled through local/commands.py so every
mutation notifies listeners/progress machinery consistently.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Set, TYPE_CHECKING

from accord_tpu_torch.local.status import Durability, Status
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes

if TYPE_CHECKING:
    from accord_tpu_torch.local.store import CommandStore


class WaitingOn:
    """Which dependencies gate this command's local execution.

    waiting_on_commit: deps not yet committed locally (executeAt unknown, so
    we cannot yet tell whether they order before or after us).
    waiting_on_apply: deps committed with executeAt < ours, not yet applied.
    (reference: Command.WaitingOn, local/Command.java:1224)
    """

    __slots__ = ("commit", "apply")

    def __init__(self):
        self.commit: Set[TxnId] = set()
        self.apply: Set[TxnId] = set()

    def is_done(self) -> bool:
        return not self.commit and not self.apply

    def __repr__(self):
        return f"WaitingOn(commit={sorted(self.commit)!r}, apply={sorted(self.apply)!r})"


class TransientListener:
    """A non-command observer of a command's transitions (e.g. a pending
    ReadData waiting for READY_TO_EXECUTE). reference: Command.TransientListener."""

    def on_change(self, store: "CommandStore", command: "Command") -> None:
        raise NotImplementedError


class Command:
    __slots__ = (
        "txn_id", "status", "durability", "promised", "accepted_ballot",
        "execute_at", "txn", "route", "deps", "accepted_scope", "writes",
        "result", "waiting_on", "waiters", "transient_listeners", "cleaned",
    )

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id
        self.status = Status.NOT_DEFINED
        self.durability = Durability.NOT_DURABLE
        self.promised: Ballot = Ballot.ZERO
        self.accepted_ballot: Ballot = Ballot.ZERO
        self.execute_at: Optional[Timestamp] = None
        self.txn: Optional[PartialTxn] = None
        self.route: Optional[Route] = None
        self.deps: Optional[Deps] = None
        # the ranges an ACCEPTED proposal's deps actually cover on this store
        # (reference: PartialDeps.covering): recovery's per-range LatestDeps
        # merge must not let a narrow higher-ballot accept mask a sibling
        # range's lower-ballot accepted deps
        self.accepted_scope = None
        self.writes: Optional[Writes] = None
        self.result = None
        self.waiting_on: Optional[WaitingOn] = None
        # commands in the same store whose WaitingOn includes us
        self.waiters: Set[TxnId] = set()
        self.transient_listeners: List[TransientListener] = []
        # tier-A truncation (reference: Cleanup.TRUNCATE_WITH_OUTCOME): the
        # conflict-registry entries (cfk rows, device lanes) were dropped,
        # but the outcome AND deps (txn/executeAt/deps/writes/result) are
        # retained so straggler replicas can still repair from us -- and
        # order the replayed applies -- until the outcome is universally
        # durable
        self.cleaned = False

    # -- knowledge predicates (the reference's Known vector) ----------------
    def has_been(self, status: Status) -> bool:
        return self.status.has_been(status)

    def is_(self, status: Status) -> bool:
        return self.status == status

    @property
    def known_route(self) -> bool:
        return self.route is not None

    @property
    def known_definition(self) -> bool:
        return self.txn is not None

    @property
    def known_execute_at(self) -> bool:
        return self.execute_at is not None and self.status.is_decided

    @property
    def known_deps(self) -> bool:
        return self.deps is not None and self.has_been(Status.COMMITTED)

    @property
    def known_outcome(self) -> bool:
        return self.writes is not None or self.is_(Status.INVALIDATED)

    def is_ready_to_execute(self) -> bool:
        """May a read at executeAt run against the data store now? Only once
        every local dependency has applied: READY_TO_EXECUTE (stable, deps
        done) or APPLIED. PRE_APPLIED is NOT enough -- the outcome is known
        but earlier writes may still be pending locally, and reading then
        returns stale data (reference: ReadData waits for the
        SaveStatus.ExecuteOn window, messages/ReadData.java:53)."""
        return self.status == Status.READY_TO_EXECUTE \
            or self.status == Status.APPLIED

    # -- listeners -----------------------------------------------------------
    def add_waiter(self, txn_id: TxnId) -> None:
        self.waiters.add(txn_id)

    def remove_waiter(self, txn_id: TxnId) -> None:
        self.waiters.discard(txn_id)

    def add_transient_listener(self, listener: TransientListener) -> None:
        self.transient_listeners.append(listener)

    def remove_transient_listener(self, listener: TransientListener) -> None:
        if listener in self.transient_listeners:
            self.transient_listeners.remove(listener)

    def __repr__(self):
        ea = f"@{self.execute_at!r}" if self.execute_at is not None else ""
        return f"Command({self.txn_id!r} {self.status.name}{ea})"
