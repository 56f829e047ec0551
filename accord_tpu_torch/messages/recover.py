"""Recovery wire protocol: BeginRecovery, WaitOnCommit, invalidation and
status-probe messages.

Role-equivalent to the reference's messages/BeginRecovery.java:55 (RecoverOk
:240), WaitOnCommit.java, BeginInvalidation.java and CheckStatus.java:80. The
handler logic follows the reference's recovery math: a RecoverOk reports, for
the recovered txn, (status, accepted ballot, executeAt), the best known deps
tagged by decision tier, and the three conflict-scan results that let the
coordinator reason about whether the original fast path can have happened.
"""
from __future__ import annotations

import enum
from typing import List, Optional, Tuple

from accord_tpu_torch.local import commands
from accord_tpu_torch.local.command import TransientListener
from accord_tpu_torch.local.commands import AcceptOutcome
from accord_tpu_torch.local.status import Durability, Status, recovery_rank
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Ranges, Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import PartialTxn, Txn


class DepsTier(enum.IntEnum):
    """How authoritative a deps entry is (reference: LatestDeps merge order --
    committed deps beat accepted proposals beat locally-calculated sets)."""
    LOCAL = 0      # calculated during this recovery round (preaccept-grade)
    PROPOSAL = 1   # an accepted slow-path proposal, ranked by ballot
    COMMITTED = 2  # final decided deps


class DepsEntry:
    """One store's contribution: deps for `covering` at a decision tier."""

    __slots__ = ("tier", "ballot", "deps", "covering")

    def __init__(self, tier: DepsTier, ballot: Ballot, deps: Deps, covering: Ranges):
        self.tier = tier
        self.ballot = ballot
        self.deps = deps
        self.covering = covering

    def __repr__(self):
        return f"DepsEntry({self.tier.name}, {self.ballot!r}, {self.deps!r})"


class BeginRecovery(Request):
    """(reference: messages/BeginRecovery.java:55)"""

    def __init__(self, txn_id: TxnId, txn: Txn, route: Route, ballot: Ballot):
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.ballot = ballot
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            partial = self.txn.slice(store.ranges, include_query=False)
            outcome = commands.recover(store, self.txn_id, partial, self.route,
                                       self.ballot)
            if outcome == AcceptOutcome.REJECTED_BALLOT:
                return RecoverNack(self.txn_id,
                                   store.command(self.txn_id).promised)
            if outcome == AcceptOutcome.TRUNCATED:
                # the record is gone but its outcome was durable: answer with
                # TRUNCATED status (counts toward the quorum) so recovery can
                # prefer informative replies and only conclude TRUNCATED when
                # nothing better exists anywhere (reference:
                # Recover.java:252-254 maxAcceptedNotTruncated)
                return RecoverOk(self.txn_id, Status.TRUNCATED, Ballot.ZERO,
                                 None, (), Deps.NONE, Deps.NONE, False,
                                 None, None)

            cmd = store.command(self.txn_id)
            entries: List[DepsEntry] = []
            if cmd.deps is not None and cmd.has_been(Status.STABLE) \
                    and not cmd.status.is_terminal:
                # committed deps cover the store's slice of the route scope
                covering = store.ranges
                if cmd.route is not None:
                    covering = covering.intersection(cmd.route.covering())
                entries.append(DepsEntry(DepsTier.COMMITTED, cmd.accepted_ballot,
                                         cmd.deps, covering))
            else:
                if cmd.is_(Status.ACCEPTED) and cmd.deps is not None:
                    # scope the proposal to the ranges its Accept actually
                    # covered (reference PartialDeps.covering): claiming the
                    # whole store slice would let a narrow higher-ballot
                    # accept mask a sibling range's accepted deps held only
                    # by other replicas
                    covering = cmd.accepted_scope \
                        if cmd.accepted_scope is not None else store.ranges
                    entries.append(DepsEntry(DepsTier.PROPOSAL, cmd.accepted_ballot,
                                             cmd.deps, covering))
                local = store.calculate_deps(self.txn_id,
                                             store.owned(self.txn.keys),
                                             self.txn_id.as_timestamp())
                entries.append(DepsEntry(DepsTier.LOCAL, Ballot.ZERO, local,
                                         store.ranges))

            if cmd.has_been(Status.PRE_COMMITTED):
                rejects, ecw, eanw = False, Deps.NONE, Deps.NONE
            else:
                rejects, ecw, eanw = store.recovery_info(self.txn_id, self.txn.keys)

            return RecoverOk(self.txn_id, cmd.status, cmd.accepted_ballot,
                             cmd.execute_at, tuple(entries), ecw, eanw, rejects,
                             cmd.writes, cmd.result)

        def reduce_fn(a, b):
            if isinstance(a, RecoverNack) or isinstance(b, RecoverNack):
                return a if isinstance(a, RecoverNack) else b
            # a truncated store contributes nothing; prefer informative state
            # from a sibling store (its knowledge covers its own ranges)
            if a.status == Status.TRUNCATED and b.status != Status.TRUNCATED:
                return b
            if b.status == Status.TRUNCATED and a.status != Status.TRUNCATED:
                return a
            # keep the decision of the most advanced store (phase, then ballot
            # within the Accept phase: an accepted invalidation at a higher
            # ballot must surface over a stale acceptance); witnessed
            # timestamps max-merge while still undecided
            hi, lo = (a, b) if recovery_rank(a.status, a.accepted_ballot) \
                >= recovery_rank(b.status, b.accepted_ballot) else (b, a)
            execute_at = hi.execute_at
            if hi.status == Status.PRE_ACCEPTED and lo.execute_at is not None:
                execute_at = max(execute_at, lo.execute_at)
            return RecoverOk(
                self.txn_id, hi.status, hi.accepted_ballot, execute_at,
                hi.deps_entries + lo.deps_entries,
                hi.earlier_committed_witness.union(lo.earlier_committed_witness),
                hi.earlier_accepted_no_witness.union(lo.earlier_accepted_no_witness),
                hi.rejects_fast_path or lo.rejects_fast_path,
                hi.writes.union(lo.writes) if hi.writes is not None
                else lo.writes,
                hi.result if hi.result is not None else lo.result)

        node.command_stores.map_reduce(self.txn.keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"BeginRecovery({self.txn_id!r}, ballot={self.ballot!r})"


class RecoverOk(Reply):
    __slots__ = ("txn_id", "status", "accepted_ballot", "execute_at",
                 "deps_entries", "earlier_committed_witness",
                 "earlier_accepted_no_witness", "rejects_fast_path",
                 "writes", "result")

    def __init__(self, txn_id: TxnId, status: Status, accepted_ballot: Ballot,
                 execute_at: Optional[Timestamp],
                 deps_entries: Tuple[DepsEntry, ...],
                 earlier_committed_witness: Deps,
                 earlier_accepted_no_witness: Deps,
                 rejects_fast_path: bool, writes, result):
        self.txn_id = txn_id
        self.status = status
        self.accepted_ballot = accepted_ballot
        self.execute_at = execute_at
        self.deps_entries = deps_entries
        self.earlier_committed_witness = earlier_committed_witness
        self.earlier_accepted_no_witness = earlier_accepted_no_witness
        self.rejects_fast_path = rejects_fast_path
        self.writes = writes
        self.result = result

    @property
    def is_fast_path_vote(self) -> bool:
        return self.execute_at is not None \
            and self.execute_at == self.txn_id.as_timestamp()

    def __repr__(self):
        return (f"RecoverOk({self.txn_id!r} {self.status.name}"
                f"@{self.execute_at!r} rejectsFP={self.rejects_fast_path})")


class RecoverNack(Reply):
    __slots__ = ("txn_id", "superseded_by")

    def __init__(self, txn_id: TxnId, superseded_by: Optional[Ballot]):
        self.txn_id = txn_id
        self.superseded_by = superseded_by

    def __repr__(self):
        return f"RecoverNack({self.txn_id!r}, by={self.superseded_by!r})"


# ---------------------------------------------------------------------------
# WaitOnCommit: await the commit of a (possibly-earlier) txn
# ---------------------------------------------------------------------------

class WaitOnCommit(Request):
    """Reply once every local store owning `participants` has the txn
    committed (executeAt decided) or terminal (reference:
    messages/WaitOnCommit.java)."""

    def __init__(self, txn_id: TxnId, participants: Seekables):
        self.txn_id = txn_id
        self.participants = participants
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        stores = [s for s in node.command_stores.all()
                  if s.owns(self.participants)]
        if not stores:
            node.reply(from_node, reply_context, WaitOnCommitOk(self.txn_id))
            return
        state = {"remaining": len(stores)}

        def one_done():
            state["remaining"] -= 1
            if state["remaining"] == 0:
                node.reply(from_node, reply_context, WaitOnCommitOk(self.txn_id))

        for store in stores:
            cmd = store.command(self.txn_id)
            if cmd.status.is_decided or cmd.status.is_terminal:
                one_done()
            else:
                cmd.add_transient_listener(_CommitWaiter(self.txn_id, one_done))
                # nudge liveness: if the awaited txn is stuck, the progress
                # machinery must drive ITS recovery
                store.progress_log.waiting(self.txn_id, Status.COMMITTED,
                                           self.participants)

    def __repr__(self):
        return f"WaitOnCommit({self.txn_id!r})"


class _CommitWaiter(TransientListener):
    def __init__(self, txn_id: TxnId, done):
        self.txn_id = txn_id
        self.done = done
        self.fired = False

    def on_change(self, store, command) -> None:
        if self.fired:
            return
        if command.status.is_decided or command.status.is_terminal:
            self.fired = True
            command.remove_transient_listener(self)
            self.done()


class WaitOnCommitOk(Reply):
    __slots__ = ("txn_id",)

    def __init__(self, txn_id: TxnId):
        self.txn_id = txn_id

    def __repr__(self):
        return f"WaitOnCommitOk({self.txn_id!r})"


# ---------------------------------------------------------------------------
# Invalidation (reference: messages/BeginInvalidation.java + Commit.Invalidate)
# ---------------------------------------------------------------------------

class BeginInvalidation(Request):
    """PREPARE phase of a blind invalidation (reference:
    messages/BeginInvalidation.java): promise `ballot` on the arbitration
    shard's replicas and report what each has witnessed — WITHOUT mutating
    command status. The coordinator only proceeds to AcceptInvalidate once a
    quorum of clean promises proves no replica witnessed the txn; mutating at
    prepare time would leave stray ACCEPTED_INVALIDATE state on replicas when
    the coordinator aborts with WitnessedElsewhere, which a later recovery
    could mistake for a chosen invalidation."""

    def __init__(self, txn_id: TxnId, ballot: Ballot, key):
        self.txn_id = txn_id
        self.ballot = ballot
        self.key = key
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        from accord_tpu_torch.primitives.keyspace import Keys
        keys = Keys([self.key])

        def map_fn(store):
            cmd = store.command(self.txn_id)
            if not cmd.status.is_terminal:
                if cmd.promised > self.ballot:
                    return InvalidateNack(self.txn_id, cmd.promised, cmd.route)
                cmd.promised = self.ballot
            # a fast-path vote is any witnessed executeAt == txnId, REGARDLESS
            # of how far the replica has since advanced (reference:
            # BeginInvalidation.java:69 acceptedFastPath) — narrowing to
            # exactly PRE_ACCEPTED would under-count potential fast voters in
            # propose_invalidate's safe-to-invalidate arithmetic
            fp = cmd.execute_at is not None \
                and cmd.execute_at == self.txn_id.as_timestamp()
            return InvalidateOk(self.txn_id, cmd.status, cmd.route, fp)

        def reduce_fn(a, b):
            if isinstance(a, InvalidateNack) or isinstance(b, InvalidateNack):
                return a if isinstance(a, InvalidateNack) else b
            return a if a.status >= b.status else b

        node.command_stores.map_reduce(keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"BeginInvalidation({self.txn_id!r}, ballot={self.ballot!r})"


class AcceptInvalidate(Request):
    """Ballot-accept a proposal to invalidate txn_id, addressed to the
    replicas of ONE shard (any shard of the txn suffices: every commit needs
    that shard's quorum, so a promised invalidation quorum blocks commits).

    Safety precondition: the sender's ballot was PREPARED on a quorum of this
    shard — by BeginInvalidation (blind path) or BeginRecovery (recovery
    path) — so accepting it cannot conflict with a chosen lower-ballot
    proposal."""

    def __init__(self, txn_id: TxnId, ballot: Ballot, key):
        self.txn_id = txn_id
        self.ballot = ballot
        self.key = key  # addresses the shard whose quorum arbitrates
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        from accord_tpu_torch.primitives.keyspace import Keys
        keys = Keys([self.key])

        def map_fn(store):
            prev_status = store.command(self.txn_id).status
            outcome = commands.accept_invalidate(store, self.txn_id, self.ballot)
            cmd = store.command(self.txn_id)
            if outcome == AcceptOutcome.REJECTED_BALLOT:
                return InvalidateNack(self.txn_id, cmd.promised, cmd.route)
            if outcome == AcceptOutcome.REDUNDANT and not cmd.is_(Status.INVALIDATED):
                # already decided (committed or beyond): cannot invalidate
                return InvalidateNack(self.txn_id, cmd.promised, cmd.route)
            # report the PRE-transition status: our own ACCEPTED_INVALIDATE
            # must not read back as "the txn was witnessed here"
            return InvalidateOk(self.txn_id, prev_status, cmd.route)

        def reduce_fn(a, b):
            if isinstance(a, InvalidateNack) or isinstance(b, InvalidateNack):
                return a if isinstance(a, InvalidateNack) else b
            return a if a.status >= b.status else b

        node.command_stores.map_reduce(keys, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"AcceptInvalidate({self.txn_id!r}, ballot={self.ballot!r})"


class InvalidateOk(Reply):
    __slots__ = ("txn_id", "status", "route", "fast_path_vote")

    def __init__(self, txn_id: TxnId, status: Status, route: Optional[Route],
                 fast_path_vote: bool = False):
        self.txn_id = txn_id
        self.status = status
        self.route = route
        # did this replica cast a ballot-0 fast-path vote (witnessed at
        # exactly txnId)? Feeds the coordinator's safe-to-invalidate
        # electorate math (reference: InvalidateReply.acceptedFastPath)
        self.fast_path_vote = fast_path_vote

    def __repr__(self):
        return f"InvalidateOk({self.txn_id!r}, {self.status.name})"


class InvalidateNack(Reply):
    __slots__ = ("txn_id", "promised", "route")

    def __init__(self, txn_id: TxnId, promised: Optional[Ballot], route):
        self.txn_id = txn_id
        self.promised = promised
        self.route = route

    def __repr__(self):
        return f"InvalidateNack({self.txn_id!r})"


class CommitInvalidate(Request):
    """Broadcast the agreed invalidation (reference: Commit.Invalidate)."""

    def __init__(self, txn_id: TxnId, participants: Seekables):
        self.txn_id = txn_id
        self.participants = participants
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            commands.commit_invalidate(store, self.txn_id)
            return InvalidateOk(self.txn_id, Status.INVALIDATED, None)

        node.command_stores.map_reduce(self.participants, map_fn,
                                       lambda a, b: a) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"CommitInvalidate({self.txn_id!r})"


# ---------------------------------------------------------------------------
# CheckStatus: durable-state probe (reference: messages/CheckStatus.java:80)
# ---------------------------------------------------------------------------

class CheckStatus(Request):
    def __init__(self, txn_id: TxnId, participants: Seekables):
        self.txn_id = txn_id
        self.participants = participants
        self.wait_for_epoch = txn_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        def map_fn(store):
            cmd = store.command_if_present(self.txn_id)
            if cmd is None or cmd.status == Status.NOT_DEFINED:
                # an empty record may be a RE-CREATED one (a waiter's
                # _init_waiting_on resurrects dropped deps): the truncation
                # horizon, not the record, is the truth for below-floor ids
                if store.is_truncated(self.txn_id, self.participants):
                    # truncation only happens behind the durability floor,
                    # but the erase floor only PROVES a majority-durable
                    # sync point witnessed the outcome (applied durably or
                    # invalidated) -- claiming UNIVERSAL here would mislead
                    # a future consumer that trusts it (e.g. data erasure)
                    return CheckStatusOk(self.txn_id, Status.TRUNCATED,
                                         Ballot.ZERO, None, None, None, None,
                                         None, None,
                                         durability=Durability.MAJORITY)
            if cmd is None:
                return CheckStatusOk(self.txn_id, Status.NOT_DEFINED,
                                     Ballot.ZERO, None, None, None, None,
                                     None, None)
            deps = cmd.deps if (cmd.deps is not None
                                and cmd.has_been(Status.STABLE)
                                and not cmd.status.is_terminal) else None
            return CheckStatusOk(self.txn_id, cmd.status, cmd.accepted_ballot,
                                 cmd.execute_at, cmd.route, cmd.txn, deps,
                                 cmd.writes, cmd.result,
                                 execute_at_decided=cmd.has_been(
                                     Status.PRE_COMMITTED),
                                 durability=cmd.durability,
                                 promised=cmd.promised)

        def reduce_fn(a, b):
            return CheckStatusOk.merge(a, b)

        node.command_stores.map_reduce(self.participants, map_fn, reduce_fn) \
            .on_success(lambda reply: node.reply(from_node, reply_context, reply)) \
            .on_failure(node.agent.on_uncaught_exception)

    def __repr__(self):
        return f"CheckStatus({self.txn_id!r})"


class CheckStatusOk(Reply):
    __slots__ = ("txn_id", "status", "accepted_ballot", "execute_at", "route",
                 "partial_txn", "stable_deps", "writes", "result",
                 "execute_at_decided", "durability", "promised")

    def __init__(self, txn_id: TxnId, status: Status, accepted_ballot: Ballot,
                 execute_at: Optional[Timestamp], route: Optional[Route],
                 partial_txn: Optional[PartialTxn], stable_deps: Optional[Deps],
                 writes, result, execute_at_decided: bool = False,
                 durability: Durability = Durability.NOT_DURABLE,
                 promised: Ballot = Ballot.ZERO):
        self.txn_id = txn_id
        self.status = status
        self.accepted_ballot = accepted_ballot
        self.execute_at = execute_at
        self.route = route
        self.partial_txn = partial_txn
        self.stable_deps = stable_deps  # deps only when STABLE+ (final)
        self.writes = writes
        self.result = result
        # True iff execute_at comes from a record that DECIDED it
        # (has_been(PRE_COMMITTED)); a PRE_ACCEPTED record's witnessed
        # timestamp is a proposal, and treating it as an applyable outcome
        # would apply a never-committed txn (the seed-3 split-brain)
        self.execute_at_decided = execute_at_decided
        # cluster-wide durability knowledge (reference CheckStatusOk carries
        # Durability too); merge takes the max -- feeds home-shard gossip
        self.durability = durability
        # highest promised ballot: prepare-phase movement is ACTIVITY even
        # when nothing is accepted yet -- the ProgressToken reads this so a
        # competing recoverer's rounds reset observers' escalation backoff
        self.promised = promised

    @staticmethod
    def merge(a: "CheckStatusOk", b: "CheckStatusOk") -> "CheckStatusOk":
        hi, lo = (a, b) if recovery_rank(a.status, a.accepted_ballot) \
            >= recovery_rank(b.status, b.accepted_ballot) else (b, a)
        txn = hi.partial_txn
        if txn is None:
            txn = lo.partial_txn
        elif lo.partial_txn is not None:
            txn = txn.union(lo.partial_txn)
        deps = hi.stable_deps
        if deps is not None and lo.stable_deps is not None:
            deps = deps.union(lo.stable_deps)
        elif deps is None:
            deps = lo.stable_deps if lo.status.is_stable else None
        writes = hi.writes
        if writes is not None and lo.writes is not None:
            writes = writes.union(lo.writes)  # per-store slices: union or lose keys
        elif writes is None:
            writes = lo.writes
        # a DECIDED executeAt always wins over a witnessed proposal (decided
        # values are unique by consensus, so two decided sides agree)
        if hi.execute_at_decided:
            execute_at, decided = hi.execute_at, True
        elif lo.execute_at_decided:
            execute_at, decided = lo.execute_at, True
        else:
            execute_at = hi.execute_at if hi.execute_at is not None \
                else lo.execute_at
            decided = False
        return CheckStatusOk(
            hi.txn_id, hi.status, hi.accepted_ballot,
            execute_at,
            hi.route if hi.route is not None else lo.route,
            txn, deps, writes,
            hi.result if hi.result is not None else lo.result,
            execute_at_decided=decided,
            durability=hi.durability.merge(lo.durability),
            promised=max(hi.promised, lo.promised))

    def to_progress_token(self):
        """Compact activity summary (reference: ProgressToken): enough for a
        liveness driver to detect cluster-wide movement between probes."""
        from accord_tpu_torch.local.status import ProgressToken
        return ProgressToken(self.durability, self.status, self.promised)

    # -- the decision-relevant slice of the reference's Known vector
    # (Status.Known, local/Status.java:126-133); only the two predicates the
    # probe's decision table consumes are materialized --------------------
    @property
    def known_definition(self) -> bool:
        """Definition known FOR THE FULL ROUTE (a partial slice is not
        enough to re-coordinate)."""
        return self.route is not None and self.partial_txn is not None \
            and self.partial_txn.covers(self.route.covering())

    @property
    def known_outcome(self) -> bool:
        """An applyable outcome: a DECIDED executeAt + definition + (for
        writes) the writes themselves. A witnessed-only executeAt (from a
        PRE_ACCEPTED record) is a proposal, not an outcome."""
        return (self.partial_txn is not None and self.execute_at is not None
                and self.execute_at_decided
                and (not self.txn_id.kind.is_write or self.writes is not None))

    def __repr__(self):
        return f"CheckStatusOk({self.txn_id!r}, {self.status.name})"
