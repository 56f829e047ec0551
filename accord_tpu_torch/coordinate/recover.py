"""Recovery coordination: Recover, Invalidate, MaybeRecover.

Role-equivalent to the reference's coordinate/Recover.java:80,
Invalidate.java:50 and MaybeRecover.java:39. Any node may recover a stalled
transaction by taking a ballot above every previous round:

  BeginRecovery to all replicas of txnId.epoch -> RecoveryTracker quorum ->
    most advanced known state decides where to resume:
      INVALIDATED            -> broadcast CommitInvalidate
      >= STABLE              -> re-execute at the decided (executeAt, deps)
      COMMITTED/PRE_COMMITTED-> stabilise+execute with committed deps
                                (CollectDeps for shards lacking coverage)
      ACCEPTED               -> re-propose the accepted (executeAt, proposal)
      ACCEPTED_INVALIDATE    -> finish the invalidation
      all <= PRE_ACCEPTED    -> the whitepaper's fast-path reasoning:
          if the tracker or any replica proves the fast path impossible
            -> invalidate
          else if earlier-accepted-no-witness txns exist -> await their
            commit, then retry (they could still commit without witnessing
            us, which would flip the decision)
          else -> propose executeAt = txnId (the fast path decision the
            original coordinator would have taken)
"""
from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.coordinate.errors import Exhausted, Invalidated, Preempted, Timeout
from accord_tpu_torch.coordinate.tracking import QuorumTracker, RecoveryTracker, RequestStatus
from accord_tpu_torch.local.status import Status, recovery_rank
from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.recover import (
    AcceptInvalidate, BeginInvalidation, BeginRecovery, CheckStatus,
    CheckStatusOk, CommitInvalidate, DepsTier, InvalidateNack, InvalidateOk,
    RecoverNack, RecoverOk, WaitOnCommit, WaitOnCommitOk,
)
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.keyspace import Keys, Ranges, Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_ import AsyncResult
from accord_tpu_torch.utils.invariants import Invariants


class Outcome(enum.Enum):
    """What recovery concluded (reference: ProgressToken)."""
    APPLIED = "applied"
    INVALIDATED = "invalidated"
    TRUNCATED = "truncated"  # produced once durability rounds + truncation land


class Recover(Callback):
    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 ballot: Ballot):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.ballot = ballot
        self.result: AsyncResult = AsyncResult()
        self.topologies = node.topology_manager.with_unsynced_epochs(
            route, txn_id.epoch, txn_id.epoch)
        # a retired txn epoch (below the universal durability floor) is
        # answered by the oldest retained topology (see
        # TopologyManager.retire_below); replies resolve TRUNCATED
        self.topology = self.topologies.for_epoch(
            max(txn_id.epoch, self.topologies.oldest_epoch()))
        self.tracker = RecoveryTracker(self.topologies, txn.keys)
        self.oks: Dict[int, RecoverOk] = {}
        self._decided = False

    @classmethod
    def recover(cls, node, txn_id: TxnId, txn: Txn, route: Route,
                ballot: Optional[Ballot] = None) -> AsyncResult:
        if ballot is None:
            ballot = Ballot.from_timestamp(node.unique_now())
        self = cls(node, txn_id, txn, route, ballot)
        node.events.on_recover(txn_id)
        for to in self.tracker.nodes():
            node.send(to, BeginRecovery(txn_id, txn, route, ballot), self)
        return self.result

    # -- BeginRecovery round -------------------------------------------------
    def on_success(self, from_node, reply) -> None:
        if self._decided or self.result.done:
            return
        if isinstance(reply, RecoverNack):
            self.node.events.on_preempted(self.txn_id)
            self.result.try_set_failure(Preempted(
                f"recovery of {self.txn_id} superseded by {reply.superseded_by}"))
            return
        assert isinstance(reply, RecoverOk)
        self.oks[from_node] = reply
        if self.tracker.on_success(from_node, reply.is_fast_path_vote) \
                == RequestStatus.SUCCESS:
            self._recover()

    def on_failure(self, from_node, failure) -> None:
        if self._decided or self.result.done:
            return
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self.result.try_set_failure(Timeout(f"recover {self.txn_id}"))

    # -- the decision (reference: Recover.recover, coordinate/Recover.java:246)
    def _recover(self) -> None:
        self._decided = True
        # prefer informative replies; conclude TRUNCATED only when NO reply
        # anywhere has surviving knowledge (reference: Recover.java:252-254,
        # maxAcceptedNotTruncated): truncation implies the outcome was
        # majority-durable, so a MaybeRecover/CheckStatus pass will repair
        # local state from whatever replicas still carry it.
        oks = [ok for ok in self.oks.values() if ok.status != Status.TRUNCATED]
        if not oks:
            self.result.try_set_success(Outcome.TRUNCATED)
            return
        best = max(oks, key=lambda ok: recovery_rank(ok.status, ok.accepted_ballot))
        status = best.status

        if status == Status.INVALIDATED:
            self._commit_invalidate()
            return
        if status.has_been(Status.STABLE):
            self._with_committed_deps(
                best.execute_at,
                lambda deps: self._resume("execute", best.execute_at, deps))
            return
        if status in (Status.COMMITTED, Status.PRE_COMMITTED):
            self._with_committed_deps(
                best.execute_at,
                lambda deps: self._resume("execute", best.execute_at, deps))
            return
        if status == Status.ACCEPTED:
            deps = self._merge_proposal()
            self._resume("propose", best.execute_at, deps)
            return
        if status == Status.ACCEPTED_INVALIDATE:
            self._invalidate()
            return

        # nothing beyond PreAccepted anywhere: fast-path reasoning. A
        # REJECTED witness (sync-point floor / expiry) also forces
        # invalidation -- proposing would commit behind the floor.
        if self.tracker.rejects_fast_path() \
                or any(ok.rejects_fast_path for ok in oks) \
                or any(ok.execute_at is not None and ok.execute_at.is_rejected
                       for ok in oks):
            self._invalidate()
            return
        eanw = Deps.merge([ok.earlier_accepted_no_witness for ok in oks])
        ecw = Deps.merge([ok.earlier_committed_witness for ok in oks])
        eanw = eanw.without(ecw.contains)
        if not eanw.is_empty():
            self._await_commits(eanw)
            return
        deps = self._merge_proposal()
        self._resume("propose", self.txn_id.as_timestamp(), deps)

    # -- deps reconstruction (reference: LatestDeps merge semantics) ---------
    # Entries arrive per STORE (sub-shard granularity), so the merge must
    # resolve the best (tier, ballot) per atomic covering fragment -- taking
    # the max at whole-shard granularity would silently drop deps for the
    # store slices the winning entry does not cover.
    def _entries_for_shard(self, shard) -> List:
        window = Ranges([shard.range])
        out = []
        for node_id in shard.nodes:
            ok = self.oks.get(node_id)
            if ok is None:
                continue
            for e in ok.deps_entries:
                if e.covering.intersects(window):
                    out.append(e)
        return out

    def _merge_latest(self, entries, window: Ranges,
                      tier_floor: Optional[DepsTier] = None) -> Tuple[Deps, List[Ranges]]:
        """Resolve per atomic fragment of `window`: among entries covering the
        fragment (at/above tier_floor if given), the max (tier, ballot)
        entries win and their slices union. Returns (deps, fragments with no
        eligible entry)."""
        out = Deps.NONE
        missing: List[Ranges] = []
        for atom in _atoms(window, [e.covering for e in entries]):
            cand = [e for e in entries if e.covering.intersects(atom)]
            if tier_floor is not None:
                cand = [e for e in cand if e.tier >= tier_floor]
            if not cand:
                missing.append(atom)
                continue
            top = max((e.tier, e.ballot) for e in cand)
            parts = [e.deps.slice(atom) for e in cand if (e.tier, e.ballot) == top]
            out = out.union(Deps.merge(parts))
        return out, missing

    def _merge_proposal(self) -> Deps:
        """Best-known deps: highest (tier, ballot) per fragment
        (reference: LatestDeps.mergeProposal)."""
        out = Deps.NONE
        for shard in self.topology.shards_for(self.txn.keys):
            deps, _ = self._merge_latest(self._entries_for_shard(shard),
                                         Ranges([shard.range]))
            out = out.union(deps)
        return out

    def _with_committed_deps(self, execute_at: Timestamp, then) -> None:
        """Union of committed-tier deps, topping up fragments without
        committed coverage via a fresh GetDeps round at executeAt (reference:
        Recover.withCommittedDeps + CollectDeps.java:39)."""
        out = Deps.NONE
        missing: List[Ranges] = []
        for shard in self.topology.shards_for(self.txn.keys):
            deps, miss = self._merge_latest(self._entries_for_shard(shard),
                                            Ranges([shard.range]),
                                            tier_floor=DepsTier.COMMITTED)
            out = out.union(deps)
            missing.extend(miss)
        if not missing:
            then(out)
            return
        window = Ranges.EMPTY
        for m in missing:
            window = window.union(m)
        keys = _slice_seekables(self.txn.keys, window)
        if keys.is_empty():
            then(out)
            return
        CollectDeps.collect(self.node, self.txn_id, keys, execute_at) \
            .on_success(lambda extra: then(out.union(extra))) \
            .on_failure(self.result.try_set_failure)

    # -- resumption via the standard coordination rounds ---------------------
    def _resume(self, phase: str, execute_at: Timestamp, deps: Deps) -> None:
        from accord_tpu_torch.coordinate.transaction import CoordinateTransaction
        CoordinateTransaction.resume(
            self.node, self.txn_id, self.txn, self.route, self.ballot,
            phase, execute_at, deps,
        ).on_success(lambda _: self.result.try_set_success(Outcome.APPLIED)) \
         .on_failure(self.result.try_set_failure)

    # -- invalidation --------------------------------------------------------
    def _invalidate(self) -> None:
        propose_invalidate(self.node, self.txn_id, self.ballot,
                           self.route.home_key) \
            .on_success(lambda _: self._commit_invalidate()) \
            .on_failure(self.result.try_set_failure)

    def _commit_invalidate(self) -> None:
        participants = self.route.participants
        for to in self.topology.nodes():
            self.node.send(to, CommitInvalidate(self.txn_id, participants))
        self.node.events.on_invalidated(self.txn_id)
        self.result.try_set_success(Outcome.INVALIDATED)

    # -- earlier-accepted-no-witness wait (reference: Recover.AwaitCommit) ---
    def _await_commits(self, waiting_on: Deps) -> None:
        ids = waiting_on.all_txn_ids()
        state = {"remaining": len(ids)}

        def one_done(_):
            state["remaining"] -= 1
            if state["remaining"] == 0:
                self._retry()

        for dep_id in ids:
            keys = waiting_on.participants_of(dep_id) or self.txn.keys
            AwaitCommit.start(self.node, dep_id, keys) \
                .on_success(one_done) \
                .on_failure(self.result.try_set_failure)

    def _retry(self) -> None:
        if self.result.done:
            return
        Recover.recover(self.node, self.txn_id, self.txn, self.route,
                        self.ballot) \
            .add_callback(lambda v, f: self.result.try_set_failure(f)
                          if f is not None else self.result.try_set_success(v))


def _atoms(window: Ranges, coverings: List[Ranges]) -> List[Ranges]:
    """Split `window` at every covering boundary into atomic fragments, each
    returned as a single-range Ranges (no entry's covering partially overlaps
    an atom)."""
    out: List[Ranges] = []
    from accord_tpu_torch.primitives.keyspace import Range
    for w in window:
        pts = {w.start, w.end}
        for rngs in coverings:
            for r in rngs:
                if r.start > w.start and r.start < w.end:
                    pts.add(r.start)
                if r.end > w.start and r.end < w.end:
                    pts.add(r.end)
        bounds = sorted(pts)
        for i in range(len(bounds) - 1):
            out.append(Ranges([Range(bounds[i], bounds[i + 1])]))
    return out


def _slice_seekables(seekables: Seekables, window: Ranges) -> Seekables:
    return seekables.slice(window)


class CollectDeps(Callback):
    """Quorum GetDeps round (reference: coordinate/CollectDeps.java:39)."""

    def __init__(self, node, txn_id: TxnId, keys: Seekables, before: Timestamp):
        self.node = node
        self.txn_id = txn_id
        self.result: AsyncResult = AsyncResult()
        topologies = node.topology_manager.with_unsynced_epochs(
            Route(None, keys), txn_id.epoch, txn_id.epoch)
        self.tracker = QuorumTracker(topologies, keys)
        self.keys = keys
        self.before = before
        self.deps = Deps.NONE

    @classmethod
    def collect(cls, node, txn_id: TxnId, keys: Seekables,
                before: Timestamp) -> AsyncResult:
        from accord_tpu_torch.messages.getdeps import GetDeps
        self = cls(node, txn_id, keys, before)
        for to in self.tracker.nodes():
            node.send(to, GetDeps(txn_id, keys, before), self)
        return self.result

    def on_success(self, from_node, reply) -> None:
        if self.result.done:
            return
        self.deps = self.deps.union(reply.deps)
        if self.tracker.on_success(from_node) == RequestStatus.SUCCESS:
            self.result.try_set_success(self.deps)

    def on_failure(self, from_node, failure) -> None:
        if self.result.done:
            return
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self.result.try_set_failure(Timeout(f"collectDeps {self.txn_id}"))


class AwaitCommit(Callback):
    """Quorum WaitOnCommit for one txn (reference: Recover.AwaitCommit)."""

    def __init__(self, node, txn_id: TxnId, participants: Seekables):
        self.result = AsyncResult()
        topologies = node.topology_manager.with_unsynced_epochs(
            Route(None, participants), txn_id.epoch, txn_id.epoch)
        self.tracker = QuorumTracker(topologies, participants)
        self.txn_id = txn_id

    @classmethod
    def start(cls, node, txn_id: TxnId, participants: Seekables) -> AsyncResult:
        self = cls(node, txn_id, participants)
        for to in self.tracker.nodes():
            node.send(to, WaitOnCommit(txn_id, participants), self)
        return self.result

    def on_success(self, from_node, reply) -> None:
        if self.tracker.on_success(from_node) == RequestStatus.SUCCESS:
            self.result.try_set_success(None)

    def on_failure(self, from_node, failure) -> None:
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self.result.try_set_failure(Timeout(f"awaitCommit {self.txn_id}"))


class WitnessedElsewhere(RuntimeError):
    """An invalidation attempt found the txn witnessed: recover it instead
    (reference: Invalidate.java switches to RecoverWithRoute)."""

    def __init__(self, txn_id: TxnId, status: Status, route: Optional[Route]):
        super().__init__(f"{txn_id} witnessed at {status.name}")
        self.status = status
        self.route = route


def propose_invalidate(node, txn_id: TxnId, ballot: Ballot, key,
                       abort_if_witnessed: bool = False) -> AsyncResult:
    """Ballot-accept invalidation on the quorum of one shard (reference:
    Propose.Invalidate.proposeInvalidate): that shard's quorum participates in
    any commit of txn_id, so a promised invalidation there blocks them all.

    The accept is only safe once `ballot` has been PREPARED on a quorum of
    the shard. With abort_if_witnessed (the blind Invalidate path, where no
    BeginRecovery round preceded us) we run that prepare here as a
    BeginInvalidation round: replicas promise the ballot *without* mutating
    status, and ANY witness aborts with WitnessedElsewhere before a single
    ACCEPTED_INVALIDATE is written — the txn's coordinator may still be
    concurrently committing its proposal, and only a full BeginRecovery round
    can reason about that safely. Without abort_if_witnessed the caller is
    the recovery coordinator, whose BeginRecovery quorum at this same ballot
    already served as the prepare."""
    topology = node.topology_manager.for_epoch(txn_id.epoch)
    shard = topology.shard_for_key(key)
    result = AsyncResult()

    def make_tracker() -> QuorumTracker:
        return QuorumTracker(
            node.topology_manager.with_unsynced_epochs(
                Route(key, Keys([key])), txn_id.epoch, txn_id.epoch),
            Keys([key]))

    def accept_round() -> None:
        tracker = make_tracker()

        class AcceptCb(Callback):
            def on_success(self, from_node, reply) -> None:
                if result.done:
                    return
                if isinstance(reply, InvalidateNack):
                    result.try_set_failure(Preempted(
                        f"invalidate {txn_id} superseded by {reply.promised}"))
                    return
                if tracker.on_success(from_node) == RequestStatus.SUCCESS:
                    result.try_set_success(None)

            def on_failure(self, from_node, failure) -> None:
                if tracker.on_failure(from_node) == RequestStatus.FAILED:
                    result.try_set_failure(Timeout(f"invalidate {txn_id}"))

        cb = AcceptCb()
        for to in shard.nodes:
            node.send(to, AcceptInvalidate(txn_id, ballot, key), cb)

    if not abort_if_witnessed:
        accept_round()
        return result

    from accord_tpu_torch.coordinate.tracking import InvalidationTracker
    prepare_tracker = InvalidationTracker(
        node.topology_manager.with_unsynced_epochs(
            Route(key, Keys([key])), txn_id.epoch, txn_id.epoch),
        Keys([key]), txn_id.epoch)

    class PrepareCb(Callback):
        # Invalidation is a NEGATIVE decision: like MaybeRecover, wait for
        # every reachable reply before acting, because (a) a bare quorum can
        # simply have missed the one witness a straggler would report, and
        # (b) dispatching the accept round while prepare replies are still in
        # flight races a late WitnessedElsewhere abort against an accepted
        # invalidation quorum — the caller would be told "recover instead"
        # after we wrote the very state that makes recovery finish the kill.
        def __init__(self):
            self.answered = 0
            self.quorum = False
            self.witnesses: list = []          # (node, status, route)

        def on_success(self, from_node, reply) -> None:
            if result.done:
                return
            self.answered += 1
            if isinstance(reply, InvalidateNack):
                result.try_set_failure(Preempted(
                    f"invalidate {txn_id} superseded by {reply.promised}"))
                return
            if reply.status.is_decided and not reply.status.is_terminal:
                # the txn got committed while we tried to invalidate it
                result.try_set_failure(Preempted(
                    f"invalidate {txn_id}: already decided ({reply.status.name})"))
                return
            if reply.status == Status.ACCEPTED:
                # an accepted slow-path proposal exists: recovery must resume
                # it, not kill it
                result.try_set_failure(
                    WitnessedElsewhere(txn_id, reply.status, reply.route))
                return
            if reply.status.has_been(Status.PRE_ACCEPTED) \
                    and reply.status != Status.ACCEPTED_INVALIDATE \
                    and not reply.status.is_terminal:
                # witnessed but undecided: defer the verdict to the
                # electorate analysis once everyone reachable has answered
                self.witnesses.append(
                    (from_node, reply.status, reply.route))
            if prepare_tracker.on_success(from_node, reply.fast_path_vote) \
                    == RequestStatus.SUCCESS:
                self.quorum = True
            self._maybe_dispatch()

        def on_failure(self, from_node, failure) -> None:
            if result.done:
                return
            self.answered += 1
            if prepare_tracker.on_failure(from_node) == RequestStatus.FAILED:
                result.try_set_failure(Timeout(f"invalidate {txn_id}"))
                return
            self._maybe_dispatch()

        def _maybe_dispatch(self) -> None:
            if self.answered < len(shard.nodes) or not self.quorum:
                return
            if self.witnesses \
                    and not prepare_tracker.is_fast_path_rejected():
                # Witnessed-but-undecided replies force recovery unless the
                # fast path is decisively dead (reference: Invalidate.java:161
                # isSafeToInvalidate via InvalidationTracker): our promises
                # block any FUTURE ballot-0 vote (preaccept is ballot-gated),
                # so the only possible fast voters are those who already
                # voted plus electorate members we could not reach; the slow
                # path is blocked by quorum intersection with our promises.
                _, status, route = max(self.witnesses, key=lambda w: w[1])
                if route is None:
                    route = next((r for _, _, r in self.witnesses
                                  if r is not None), None)
                result.try_set_failure(
                    WitnessedElsewhere(txn_id, status, route))
                return
            accept_round()

    prep = PrepareCb()
    for to in shard.nodes:
        node.send(to, BeginInvalidation(txn_id, ballot, key), prep)
    return result


def invalidate_unwitnessed(node, txn_id: TxnId, participants: Seekables) -> AsyncResult:
    """Invalidate a txn known only by id (no definition/route reachable) --
    reference: Invalidate.java:50. Uses any key it was seen under. If a
    witness surfaces, falls back to probing (and hence recovering) it."""
    ballot = Ballot.from_timestamp(node.unique_now())
    some_key = next(iter(participants)) if isinstance(participants, Keys) \
        else participants[0].start
    result = AsyncResult()

    def committed(_):
        topology = node.topology_manager.for_epoch(txn_id.epoch)
        for to in topology.nodes():
            node.send(to, CommitInvalidate(txn_id, participants))
        result.try_set_success(Outcome.INVALIDATED)

    def failed(failure):
        if isinstance(failure, WitnessedElsewhere):
            # re-probe WITHOUT permission to invalidate again: breaks the
            # probe->invalidate->probe mutual recursion; the progress engine
            # retries from scratch later if this pass can't resolve it
            scope = failure.route.participants if failure.route is not None \
                else participants
            MaybeRecover.probe(node, txn_id, scope, allow_invalidate=False) \
                .add_callback(
                    lambda v, f: result.try_set_failure(f) if f is not None
                    else result.try_set_success(v))
        else:
            result.try_set_failure(failure)

    propose_invalidate(node, txn_id, ballot, some_key,
                       abort_if_witnessed=True) \
        .on_success(committed) \
        .on_failure(failed)
    return result


# ---------------------------------------------------------------------------
# MaybeRecover: probe, repair locally, or escalate
# ---------------------------------------------------------------------------

class MaybeRecover(Callback):
    """CheckStatus probe for a stalled txn; apply anything learned locally
    (the reference's Propagate), else escalate to full Recover/Invalidate
    (reference: MaybeRecover.java:39, RecoverWithRoute.java:57).

    Positive knowledge (an outcome, an invalidation) acts as soon as it
    arrives with a quorum; NEGATIVE decisions (recover from scratch,
    invalidate an apparently-unwitnessed txn) wait for every reachable reply,
    because a bare quorum can simply have missed the one witness."""

    def __init__(self, node, txn_id: TxnId, participants: Seekables,
                 allow_invalidate: bool, token_sink=None):
        self.node = node
        self.txn_id = txn_id
        self.participants = participants
        self.allow_invalidate = allow_invalidate
        # observer of the merged ProgressToken (reference: MaybeRecover
        # completes with a ProgressToken; the progress engine compares
        # successive tokens to detect remote movement)
        self.token_sink = token_sink
        self.result: AsyncResult = AsyncResult()
        self.topologies = node.topology_manager.with_unsynced_epochs(
            Route(None, participants), txn_id.epoch, txn_id.epoch)
        self.tracker = QuorumTracker(self.topologies, participants)
        self.oks: List[CheckStatusOk] = []
        self.contacted = 0
        self.answered = 0
        self._acted = False

    @classmethod
    def probe(cls, node, txn_id: TxnId, participants: Seekables,
              allow_invalidate: bool = True, token_sink=None) -> AsyncResult:
        self = cls(node, txn_id, participants, allow_invalidate, token_sink)
        targets = self.tracker.nodes()
        self.contacted = len(targets)
        for to in targets:
            node.send(to, CheckStatus(txn_id, participants), self)
        return self.result

    def on_success(self, from_node, reply) -> None:
        if self._acted:
            return
        self.oks.append(reply)
        self.answered += 1
        self.tracker.on_success(from_node)
        self._maybe_act()

    def on_failure(self, from_node, failure) -> None:
        if self._acted:
            return
        self.answered += 1
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self._acted = True
            self.result.try_set_failure(Timeout(f"checkStatus {self.txn_id}"))
            return
        self._maybe_act()

    def _merged(self) -> CheckStatusOk:
        merged = self.oks[0]
        for ok in self.oks[1:]:
            merged = CheckStatusOk.merge(merged, ok)
        return merged

    def _maybe_act(self) -> None:
        if not self.oks:
            if self.answered >= self.contacted:
                self._acted = True
                self.result.try_set_failure(Timeout(f"checkStatus {self.txn_id}"))
            return
        merged = self._merged()
        if self.token_sink is not None:
            self.token_sink(merged.to_progress_token())
        have_quorum = self.tracker.decided == RequestStatus.SUCCESS
        all_in = self.answered >= self.contacted

        # positive knowledge: act as soon as it is quorum-confirmed reachable
        if have_quorum and merged.status == Status.INVALIDATED:
            self._acted = True
            self._propagate_invalidate(merged)
            return
        if have_quorum and merged.status == Status.TRUNCATED:
            # someone truncated the record: the outcome was durable. Apply it
            # if the MERGED knowledge still carries it (a node-local merge
            # can collapse an outcome-carrying store with a truncated sibling
            # to status TRUNCATED while keeping txn/writes/executeAt);
            # otherwise mark local records truncated so dependents stop
            # waiting (reference: Infer/Cleanup propagation of truncation)
            self._acted = True
            if merged.known_outcome:
                self._propagate_outcome(merged)
            else:
                self._propagate_truncated(merged)
            return
        if have_quorum and merged.status.has_been(Status.PRE_APPLIED) \
                and not merged.status.is_terminal:
            self._acted = True
            self._propagate_outcome(merged)
            return
        if not all_in:
            return  # wait for the stragglers before a negative decision
        if not have_quorum:
            self._acted = True
            self.result.try_set_failure(Timeout(f"checkStatus {self.txn_id}"))
            return
        self._acted = True
        if merged.status.has_been(Status.PRE_APPLIED) \
                and not merged.status.is_terminal:
            self._propagate_outcome(merged)
            return
        if merged.status == Status.INVALIDATED:
            self._propagate_invalidate(merged)
            return
        if merged.known_definition:
            txn = merged.partial_txn.reconstitute()
            Recover.recover(self.node, self.txn_id, txn, merged.route) \
                .add_callback(self._finish)
            return
        if merged.route is not None \
                and not merged.route.covering().contains_ranges(
                    self.participants.to_ranges()) \
                and not self.participants.to_ranges().contains_ranges(
                    merged.route.participants.to_ranges()):
            # learn the full participant set, then retry with the full route
            # -- but ONLY if the route actually adds participants we have not
            # probed, else this recurses on itself forever (a partially-known
            # definition can leave route.covering() narrower than the
            # participants that witnessed it)
            MaybeRecover.probe(self.node, self.txn_id,
                               merged.route.participants,
                               self.allow_invalidate) \
                .add_callback(self._finish)
            return
        if not self.allow_invalidate:
            self.result.try_set_failure(Exhausted(
                f"probe {self.txn_id}: witnessed but unrecoverable yet"))
            return
        # no replica knows the definition: race to invalidate it
        invalidate_unwitnessed(self.node, self.txn_id, self.participants) \
            .add_callback(self._finish)

    def _finish(self, value, failure) -> None:
        if failure is not None:
            self.result.try_set_failure(failure)
        else:
            if value is Outcome.TRUNCATED:
                # a full Recover concluded every reachable replica truncated
                # the record (outcome universally durable + erased): mark our
                # local records truncated too, so dependents drop their wait
                # edges instead of probing forever
                from accord_tpu_torch.messages.propagate import Propagate
                self.node.receive_local(Propagate(
                    Propagate.TRUNCATE, self.txn_id, self.participants))
            self.result.try_set_success(value)

    # -- Propagate (messages/propagate.py; reference: Propagate.java:64).
    # Local application is a journaled LocalRequest: state repaired by a
    # probe must survive a restart's journal replay.
    def _propagate_invalidate(self, merged: Optional[CheckStatusOk] = None) -> None:
        from accord_tpu_torch.messages.propagate import Propagate
        self.node.receive_local(Propagate(
            Propagate.INVALIDATE, self.txn_id, self.participants, merged))
        self.result.try_set_success(Outcome.INVALIDATED)

    def _inform_home_durable(self, merged: CheckStatusOk) -> None:
        """The probe discovered a durable outcome: forward that knowledge to
        the home shard so its engine stops recovery-driving (reference:
        MaybeRecover.java:109 sends InformDurable to the home shard nodes)."""
        from accord_tpu_torch.local.status import Durability
        from accord_tpu_torch.messages.inform import InformHomeDurable
        if merged.route is None or merged.durability < Durability.MAJORITY:
            return
        try:
            shard = self.node.topology_manager.current().shard_for_key(
                merged.route.home_key)
        except Exception:
            return  # home range not in the current topology view
        for to in shard.nodes:
            if to != self.node.id:
                self.node.counters["informs_home_durable_sent"] += 1
                self.node.send(to, InformHomeDurable(
                    self.txn_id, merged.route, merged.execute_at,
                    merged.durability))

    def _propagate_truncated(self, merged: CheckStatusOk) -> None:
        from accord_tpu_torch.messages.propagate import Propagate
        self.node.receive_local(Propagate(
            Propagate.TRUNCATE, self.txn_id, self.participants, merged))
        self._inform_home_durable(merged)
        self.result.try_set_success(Outcome.TRUNCATED)

    def _propagate_outcome(self, merged: CheckStatusOk) -> None:
        """Apply a remotely-known outcome to our local stores; if no merged
        reply covers our slices, fall back to a full Recover (re-executes)."""
        from accord_tpu_torch.messages.propagate import Propagate, covering_stores
        self._inform_home_durable(merged)
        if covering_stores(self.node, self.txn_id, self.participants, merged):
            self.node.receive_local(Propagate(
                Propagate.OUTCOME, self.txn_id, self.participants, merged))
            self.result.try_set_success(Outcome.APPLIED)
        else:
            # outcome exists but no reply covers us: recover (re-executes)
            if merged.route is not None and merged.partial_txn is not None \
                    and merged.partial_txn.covers(merged.route.covering()):
                Recover.recover(self.node, self.txn_id,
                                merged.partial_txn.reconstitute(), merged.route) \
                    .add_callback(self._finish)
            else:
                self.result.try_set_failure(Exhausted(
                    f"propagate {self.txn_id}: no covering outcome"))
