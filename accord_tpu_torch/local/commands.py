"""Command state transitions.

Role-equivalent to the reference's Commands static functions
(local/Commands.java:90): preaccept (:113), accept (:202), commit (:289),
apply (:462), commitInvalidate (:434), and the execution scheduling walk
(maybeExecute / updateDependencyAndMaybeExecute :777 / NotifyWaitingOn :960).
Every mutation of a Command flows through here so listener notification,
conflict-registry registration and progress-log callbacks stay consistent.
"""
from __future__ import annotations

import enum
from typing import Optional, Set

from accord_tpu_torch.local.cfk import CfkStatus
from accord_tpu_torch.local.command import Command, WaitingOn
from accord_tpu_torch.local.status import Durability, Status
from accord_tpu_torch.local.store import CommandStore
from accord_tpu_torch.obs.trace import REC, node_pid, node_ts
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Keys, Ranges
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import (
    Ballot, Domain, Timestamp, TxnId, TxnKind,
)
from accord_tpu_torch.primitives.txn import PartialTxn
from accord_tpu_torch.primitives.writes import Writes
from accord_tpu_torch.utils.invariants import Invariants


class AcceptOutcome(enum.Enum):
    SUCCESS = "success"
    REDUNDANT = "redundant"
    REJECTED_BALLOT = "rejected_ballot"
    TRUNCATED = "truncated"


def _rec_step(store: CommandStore, txn_id: TxnId, name: str) -> None:
    """Replica-side lifecycle instant: one flow step on this node's txn
    track, linking it into the coordinator's span (obs/trace.py). Callers
    guard on REC.enabled so the disabled path stays a single attr check."""
    node = store.node
    REC.txn_step(node_pid(node), txn_id, name, node_ts(node))


# ---------------------------------------------------------------------------
# PreAccept
# ---------------------------------------------------------------------------

def preaccept(store: CommandStore, txn_id: TxnId, txn: PartialTxn, route: Route,
              ballot: Ballot = Ballot.ZERO) -> AcceptOutcome:
    """Witness the txn: record definition, pick the witnessed timestamp
    (stored provisionally in execute_at), register the conflict.
    (reference: Commands.preacceptOrRecover, local/Commands.java:125)"""
    if store.is_truncated(txn_id, txn.keys):
        return AcceptOutcome.TRUNCATED
    cmd = store.command(txn_id)
    if cmd.status.is_terminal:
        return AcceptOutcome.REJECTED_BALLOT if cmd.is_(Status.INVALIDATED) \
            else AcceptOutcome.TRUNCATED
    if cmd.promised > ballot:
        return AcceptOutcome.REJECTED_BALLOT
    if cmd.known_definition:
        # duplicate delivery or competing recovery; just raise the promise
        cmd.promised = max(cmd.promised, ballot)
        return AcceptOutcome.REDUNDANT if ballot == Ballot.ZERO else AcceptOutcome.SUCCESS

    cmd.txn = txn if cmd.txn is None else cmd.txn
    cmd.route = route if cmd.route is None else cmd.route
    cmd.promised = max(cmd.promised, ballot)

    if cmd.execute_at is None:
        if txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT:
            # advance the reject floor BEFORE computing the witness timestamp
            # (reference: PreAccept.java:101-103 + CommandStore.preaccept:333)
            store.mark_exclusive_sync_point(txn_id, store.owned(txn.keys))
        # recovery (non-zero ballot) must not take new fast-path decisions
        witnessed = store.preaccept_timestamp(txn_id, store.owned(txn.keys),
                                              permit_fast_path=(ballot == Ballot.ZERO))
        cmd.execute_at = witnessed
        cmd.status = Status.PRE_ACCEPTED
        if REC.enabled:
            _rec_step(store, txn_id, "preaccepted")
        store.register(txn_id, txn.keys, CfkStatus.WITNESSED, witnessed)
        store.progress_log.preaccepted(cmd, _is_home(store, cmd))
    else:
        cmd.status = max(cmd.status, Status.PRE_ACCEPTED)

    notify_listeners(store, cmd)
    return AcceptOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Accept (slow-path executeAt proposal)
# ---------------------------------------------------------------------------

def accept(store: CommandStore, txn_id: TxnId, ballot: Ballot, route: Route,
           keys, execute_at: Timestamp,
           deps: Optional[Deps] = None) -> AcceptOutcome:
    """(reference: Commands.accept, local/Commands.java:202). `deps` is the
    coordinator's proposal, retained so recovery can reconstruct the latest
    accepted proposal (reference stores partialDeps on the Accepted command)."""
    if store.is_truncated(txn_id, keys):
        return AcceptOutcome.TRUNCATED
    cmd = store.command(txn_id)
    if cmd.status.is_terminal:
        return AcceptOutcome.REJECTED_BALLOT if cmd.is_(Status.INVALIDATED) \
            else AcceptOutcome.TRUNCATED
    if cmd.promised > ballot:
        return AcceptOutcome.REDUNDANT if cmd.has_been(Status.COMMITTED) \
            else AcceptOutcome.REJECTED_BALLOT
    if cmd.has_been(Status.COMMITTED):
        return AcceptOutcome.REDUNDANT
    if not cmd.known_definition and cmd.execute_at is None \
            and store.is_rejected_if_not_preaccepted(txn_id, keys):
        # never witnessed here and below an ExclusiveSyncPoint floor: refuse
        # the proposal rather than commit behind the floor (reference:
        # CommandStore.isRejectedIfNotPreAccepted, local/CommandStore.java:589)
        return AcceptOutcome.REJECTED_BALLOT

    cmd.route = route if cmd.route is None else cmd.route
    cmd.execute_at = execute_at
    cmd.promised = ballot
    cmd.accepted_ballot = ballot
    if deps is not None:
        cmd.deps = deps.slice(store.ranges)
        cmd.accepted_scope = keys.to_ranges()
    cmd.status = Status.ACCEPTED
    if REC.enabled:
        _rec_step(store, txn_id, "accepted")
    store.register(txn_id, keys, CfkStatus.WITNESSED, execute_at)
    store.progress_log.accepted(cmd, _is_home(store, cmd))
    notify_listeners(store, cmd)
    return AcceptOutcome.SUCCESS


def recover(store: CommandStore, txn_id: TxnId, txn: PartialTxn, route: Route,
            ballot: Ballot) -> AcceptOutcome:
    """Ballot-gated witness for a BeginRecovery round (reference:
    Commands.recover via preacceptOrRecover, local/Commands.java:125-200):
    promise `ballot`, witnessing the txn first if this replica never saw it.
    A fresh recovery witness never permits a fast-path vote: recovery wants
    to invalidate txns their original coordinator did not complete
    (reference: permitFastPath = ballot.equals(Ballot.ZERO),
    local/Commands.java:163-169)."""
    if store.is_truncated(txn_id, txn.keys):
        return AcceptOutcome.TRUNCATED
    cmd = store.command(txn_id)
    if cmd.is_(Status.TRUNCATED):
        return AcceptOutcome.TRUNCATED
    if cmd.promised > ballot:
        return AcceptOutcome.REJECTED_BALLOT
    cmd.promised = ballot
    if not cmd.known_definition and not cmd.is_(Status.INVALIDATED):
        cmd.txn = txn
        cmd.route = route if cmd.route is None else cmd.route
        # only witness a timestamp if this replica NEVER witnessed the txn:
        # an ACCEPTED-without-definition command (Accept carries no txn body)
        # must keep its accepted executeAt/status -- re-witnessing would
        # erase the accept that may have formed the commit quorum and let
        # recovery invalidate a committed txn (reference: preacceptOrRecover
        # only applies the witness below PreAccepted, local/Commands.java:125-200)
        if not cmd.has_been(Status.PRE_ACCEPTED):
            if txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT:
                store.mark_exclusive_sync_point(txn_id, store.owned(txn.keys))
            witnessed = store.preaccept_timestamp(txn_id, store.owned(txn.keys),
                                                  permit_fast_path=False)
            cmd.execute_at = witnessed
            cmd.status = Status.PRE_ACCEPTED
            store.register(txn_id, txn.keys, CfkStatus.WITNESSED, witnessed)
        notify_listeners(store, cmd)
    return AcceptOutcome.SUCCESS


def accept_invalidate(store: CommandStore, txn_id: TxnId, ballot: Ballot) -> AcceptOutcome:
    """Ballot-accept a proposal to invalidate (reference: Commands.acceptInvalidate)."""
    cmd = store.command(txn_id)
    if cmd.status.is_terminal:
        return AcceptOutcome.REDUNDANT
    if cmd.promised > ballot:
        return AcceptOutcome.REJECTED_BALLOT
    if cmd.status.is_decided:
        # executeAt is decided (PRE_COMMITTED or beyond): too late to
        # invalidate (reference gates on hasBeen(PreCommitted))
        return AcceptOutcome.REDUNDANT
    cmd.promised = ballot
    cmd.accepted_ballot = ballot
    # supersedes even an ACCEPTED proposal: the higher ballot wins the Accept
    # phase, and leaving the status at ACCEPTED would hide this replica's
    # accepted invalidation from recovery (reference: Commands.acceptInvalidate
    # sets SaveStatus.AcceptedInvalidate over Accepted)
    cmd.status = Status.ACCEPTED_INVALIDATE
    notify_listeners(store, cmd)
    return AcceptOutcome.SUCCESS


# ---------------------------------------------------------------------------
# Commit
# ---------------------------------------------------------------------------

class CommitOutcome(enum.Enum):
    SUCCESS = "success"
    REDUNDANT = "redundant"
    INSUFFICIENT = "insufficient"


def commit(store: CommandStore, txn_id: TxnId, route: Route, txn: Optional[PartialTxn],
           execute_at: Timestamp, deps: Deps) -> CommitOutcome:
    """Commit(Stable): executeAt + deps are final; build the local wait graph
    and schedule execution (reference: Commands.commit, local/Commands.java:289)."""
    if store.is_truncated(txn_id, route.participants):
        return CommitOutcome.REDUNDANT  # below the truncation horizon
    cmd = store.command(txn_id)
    if cmd.has_been(Status.STABLE):
        if not cmd.status.is_terminal and cmd.execute_at != execute_at:
            store.node.agent.on_inconsistent_timestamp(cmd, cmd.execute_at, execute_at)
        return CommitOutcome.REDUNDANT
    if cmd.txn is None and txn is None:
        return CommitOutcome.INSUFFICIENT
    if txn is not None:
        cmd.txn = txn if cmd.txn is None else cmd.txn.union(txn)
    cmd.route = route if cmd.route is None else cmd.route
    cmd.execute_at = execute_at
    cmd.deps = deps
    cmd.status = Status.STABLE
    if REC.enabled:
        _rec_step(store, txn_id, "stable")
    store.register(txn_id, cmd.txn.keys, CfkStatus.COMMITTED,
                   max(execute_at, txn_id.as_timestamp()), execute_at)
    if txn_id.kind is TxnKind.WRITE and txn_id.domain is Domain.KEY:
        # transitive-dependency elision: the deps this write really waits
        # for are now covered by a single dep on it
        store.register_commit_cover(txn_id, execute_at, deps)
    _init_waiting_on(store, cmd)
    if store.exec_plane is not None:
        store.exec_plane.on_stable(cmd)
    store.progress_log.stable(cmd, _is_home(store, cmd))
    store.node.events.on_stable(cmd)
    notify_listeners(store, cmd)
    maybe_execute(store, cmd)
    return CommitOutcome.SUCCESS


def precommit(store: CommandStore, txn_id: TxnId, execute_at: Timestamp) -> None:
    """executeAt learned (e.g. via recovery/propagate) without deps
    (reference: Commands.precommit, local/Commands.java:353)."""
    cmd = store.command(txn_id)
    if cmd.has_been(Status.PRE_COMMITTED) or cmd.status.is_terminal:
        return
    cmd.execute_at = execute_at
    cmd.status = Status.PRE_COMMITTED
    if cmd.txn is not None:
        store.register(txn_id, cmd.txn.keys, CfkStatus.COMMITTED,
                       max(execute_at, txn_id.as_timestamp()), execute_at)
    notify_listeners(store, cmd)


def commit_invalidate(store: CommandStore, txn_id: TxnId) -> None:
    """(reference: Commands.commitInvalidate, local/Commands.java:434)"""
    cmd = store.command(txn_id)
    if cmd.status.is_terminal:
        return  # a TRUNCATED record may have been stable; nothing to assert
    if cmd.has_been(Status.STABLE):
        Invariants.check_state(False, "invalidating a stable command %s", cmd)
    cmd.status = Status.INVALIDATED
    if cmd.txn is not None:
        store.register(txn_id, cmd.txn.keys, CfkStatus.INVALIDATED, txn_id.as_timestamp())
    store.node.events.on_invalidated(txn_id)
    store.progress_log.clear(txn_id)
    notify_listeners(store, cmd)


# ---------------------------------------------------------------------------
# Apply / execution
# ---------------------------------------------------------------------------

def apply(store: CommandStore, txn_id: TxnId, route: Route, txn: Optional[PartialTxn],
          execute_at: Timestamp, deps: Deps, writes: Optional[Writes], result) -> CommitOutcome:
    """Persist the outcome; execute (write to the data store) once local deps
    have applied (reference: Commands.apply, local/Commands.java:462)."""
    if store.is_truncated(txn_id, route.participants):
        return CommitOutcome.REDUNDANT  # below the truncation horizon
    cmd = store.command(txn_id)
    if cmd.has_been(Status.PRE_APPLIED):
        if not cmd.status.is_terminal and cmd.execute_at != execute_at:
            store.node.agent.on_inconsistent_timestamp(cmd, cmd.execute_at, execute_at)
        return CommitOutcome.REDUNDANT
    if cmd.txn is None and txn is None:
        return CommitOutcome.INSUFFICIENT
    if txn is not None:
        cmd.txn = txn if cmd.txn is None else cmd.txn.union(txn)
    cmd.route = route if cmd.route is None else cmd.route
    was_stable = cmd.has_been(Status.STABLE)
    cmd.execute_at = execute_at
    if not was_stable:
        # the committed deps supersede any accepted-proposal deps we retained
        cmd.deps = deps
    cmd.writes = writes
    cmd.result = result
    cmd.status = Status.PRE_APPLIED
    store.register(txn_id, cmd.txn.keys, CfkStatus.COMMITTED,
                   max(execute_at, txn_id.as_timestamp()), execute_at)
    if not was_stable:
        _init_waiting_on(store, cmd)
    if store.exec_plane is not None:
        store.exec_plane.on_stable(cmd)   # re-ingest at the apply stage
    store.progress_log.executed(cmd, _is_home(store, cmd))
    notify_listeners(store, cmd)
    maybe_execute(store, cmd)
    return CommitOutcome.SUCCESS


def needed_dep_ids(store: CommandStore, cmd: Command) -> Set[TxnId]:
    """The dep ids that still need a local wait edge, with PER-(key, dep)
    floor elision: a dep row under key k is elided when k's bootstrap floor
    (effects arrived with the fetched snapshot) or truncation floor (applied
    locally before the floor advanced) lies above the dep. A dep keeps its
    edge iff SOME key it shares with us is unfloored -- strictly sharper than
    the min-floor-over-all-our-keys rule, which under mixed ownership (one
    key bootstrapped, another original) elides nothing and leaves waits on
    deps that can never individually commit here (reference:
    RedundantBefore's per-range bounds applied in WaitingOn.Update)."""
    deps = cmd.deps.slice(store.ranges) if cmd.deps is not None else None
    return needed_dep_ids_for(store, deps, cmd.txn_id)


def needed_dep_ids_for(store: CommandStore, deps: Optional[Deps],
                       self_id: TxnId) -> Set[TxnId]:
    """Core of needed_dep_ids, reusable for dep sets with no command record
    (ephemeral reads wait on deps without ever becoming commands)."""
    out: Set[TxnId] = set()
    if deps is None or deps.is_empty():
        return out
    from accord_tpu_torch.local.store import _min_floor_over_range

    def floor_for_key(k):
        b = store.bootstrapped_at.get(k)
        t = store.truncated_before.get(k)
        if b is None:
            return t
        if t is None:
            return b
        return b if b > t else t

    for k, ids in deps.key_deps.items():
        f = floor_for_key(k)
        for d in ids:
            if d != self_id and (f is None or not d < f):
                out.add(d)
    for r, ids in deps.range_deps.items():
        fb = _min_floor_over_range(store.bootstrapped_at, r.start, r.end)
        ft = _min_floor_over_range(store.truncated_before, r.start, r.end)
        f = fb if ft is None or (fb is not None and fb > ft) else ft
        for d in ids:
            if d != self_id and (f is None or not d < f):
                out.add(d)
    return out


def _init_waiting_on(store: CommandStore, cmd: Command) -> None:
    """Build WaitingOn from deps: every dep on a key/range this store owns
    gates us until it is committed; committed deps executing before us gate us
    until applied (reference: Command.WaitingOn.Update + Commands.maybeExecute).

    awaits_only_deps kinds (ExclusiveSyncPoint, EphemeralRead) have no logical
    executeAt: they wait for EVERY dep to apply, even ones whose executeAt is
    later (reference: Txn.Kind.awaitsOnlyDeps; PreAccept.java:275-283 explains
    why an ESP must wait out deps that execute at arbitrary future points)."""
    wo = WaitingOn()
    cmd.waiting_on = wo
    awaits_all = cmd.txn_id.kind.awaits_only_deps
    for dep_id in needed_dep_ids(store, cmd):
        dep = store.command(dep_id)
        if dep.is_(Status.INVALIDATED):
            continue
        if dep.known_execute_at:
            if dep.has_been(Status.APPLIED) or \
                    (not awaits_all and dep.execute_at > cmd.execute_at):
                continue
            wo.apply.add(dep_id)
            dep.add_waiter(cmd.txn_id)
        else:
            wo.commit.add(dep_id)
            dep.add_waiter(cmd.txn_id)
    if not wo.is_done():
        store.live_waiters.add(cmd.txn_id)


def maybe_execute(store: CommandStore, cmd: Command) -> None:
    """(reference: Commands.maybeExecute, local/Commands.java:713)"""
    if cmd.status not in (Status.STABLE, Status.PRE_APPLIED):
        return
    if cmd.waiting_on is not None and not cmd.waiting_on.is_done():
        _report_waiting(store, cmd)
        return
    if cmd.status == Status.STABLE:
        cmd.status = Status.READY_TO_EXECUTE
        store.progress_log.readyToExecute(cmd)
        notify_listeners(store, cmd)
    else:  # PRE_APPLIED -> perform the writes
        _do_apply(store, cmd)


def _do_apply(store: CommandStore, cmd: Command) -> None:
    if cmd.writes is not None:
        # pre-bootstrap gating (reference: Commands.applyChain consulting
        # RedundantBefore PRE_BOOTSTRAP status): a txn ordered below this
        # store's bootstrap floor had its effects delivered by the fetched
        # snapshot; re-applying here would double-write
        cmd.writes.apply_to(store, store.apply_ranges_for(cmd.txn_id))
    cmd.status = Status.APPLIED
    if REC.enabled:
        _rec_step(store, cmd.txn_id, "applied")
    cmd.durability = cmd.durability.merge(Durability.LOCAL)
    if cmd.txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT:
        # every conflicting txn below the ESP has now applied locally
        store.mark_exclusive_sync_point_locally_applied(
            cmd.txn_id, store.owned(cmd.txn.keys))
    store.register(cmd.txn_id, cmd.txn.keys, CfkStatus.APPLIED,
                   max(cmd.execute_at, cmd.txn_id.as_timestamp()), cmd.execute_at)
    store.node.events.on_applied(cmd, 0.0)
    store.progress_log.clear(cmd.txn_id)
    notify_listeners(store, cmd)


def _report_waiting(store: CommandStore, cmd: Command) -> None:
    wo = cmd.waiting_on
    if wo.commit:
        blocked = min(wo.commit)
        store.progress_log.waiting(blocked, Status.COMMITTED,
                                   _dep_participants(store, cmd, blocked))
    elif wo.apply:
        blocked = min(wo.apply)
        store.progress_log.waiting(blocked, Status.APPLIED,
                                   _dep_participants(store, cmd, blocked))


def _dep_participants(store: CommandStore, cmd: Command, dep_id: TxnId):
    """Where (which keys) the blocking dependency is known to participate --
    the shards a CheckStatus/recovery probe for it must contact. Prefer the
    dep's own witnessed route; fall back to the waiter's deps index."""
    dep = store.command_if_present(dep_id)
    if dep is not None and dep.route is not None:
        return dep.route.participants
    if cmd.deps is not None:
        return cmd.deps.participants_of(dep_id)
    return None


# ---------------------------------------------------------------------------
# Listener notification (the dependency-graph walk)
# ---------------------------------------------------------------------------

def notify_listeners(store: CommandStore, cmd: Command) -> None:
    """Tell every dependent command and transient listener that `cmd` changed
    (reference: AbstractSafeCommandStore.notifyListeners +
    Commands.NotifyWaitingOn)."""
    # a waiter can only transition when the dep decided its executeAt, became
    # terminal, or applied (which implies decided): walking the waiter list
    # on pre-commit changes would visit every edge for nothing. The dep's
    # state is computed ONCE outside the loop -- this walk is the hottest
    # protocol loop in the system (reference:
    # Commands.updateDependencyAndMaybeExecute, local/Commands.java:777).
    plane = store.exec_plane
    if plane is not None:
        plane.on_status(cmd)
    if store.cmd_plane is not None:
        # keep the device command arena's row lanes tracking host-side
        # transitions (recovery, invalidation, durability merges)
        store.cmd_plane.on_status(cmd)
    terminal = cmd.is_(Status.INVALIDATED) or cmd.is_(Status.TRUNCATED)
    if cmd.waiters and (terminal or cmd.known_execute_at):
        d = cmd.txn_id
        applied = cmd.has_been(Status.APPLIED)
        exec_at = cmd.execute_at
        for waiter_id in list(cmd.waiters):
            waiter = store.command_if_present(waiter_id)
            wo = waiter.waiting_on if waiter is not None else None
            if wo is None:
                cmd.remove_waiter(waiter_id)
                continue
            changed = False
            if terminal:
                wo.commit.discard(d)
                wo.apply.discard(d)
                cmd.remove_waiter(waiter_id)
                changed = True
            elif d in wo.commit:   # executeAt now known
                wo.commit.discard(d)
                if applied or (not waiter_id.kind.awaits_only_deps
                               and exec_at > waiter.execute_at):
                    cmd.remove_waiter(waiter_id)
                else:
                    wo.apply.add(d)
                changed = True
            elif applied and d in wo.apply:
                wo.apply.discard(d)
                cmd.remove_waiter(waiter_id)
                changed = True
            if changed and wo.is_done():
                store.live_waiters.discard(waiter_id)
                if plane is not None:
                    # primary exec plane: the RELEASE comes from the device
                    # frontier harvest (the host wait-graph stays maintained
                    # as the differential oracle asserted at release time)
                    continue
                # defer through the scheduler: a long chain of dependent
                # commands resolving at once must not recurse (apply A ->
                # notify B -> apply B -> ...); the reference gets this for
                # free from per-store executors
                store.node.scheduler.once(
                    0.0, lambda w=waiter: maybe_execute(store, w))
    for listener in list(cmd.transient_listeners):
        listener.on_change(store, cmd)


def set_durability(store: CommandStore, txn_id: TxnId, durability: Durability) -> None:
    cmd = store.command(txn_id)
    cmd.durability = cmd.durability.merge(durability)


def _is_home(store: CommandStore, cmd: Command) -> bool:
    return cmd.route is not None and store.ranges.contains_key(cmd.route.home_key)
