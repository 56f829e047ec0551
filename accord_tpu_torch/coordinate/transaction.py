"""CoordinateTransaction: the client-side transaction driver.

Role-equivalent to the reference's CoordinateTransaction + CoordinationAdapter
chain (coordinate/CoordinateTransaction.java:50, Propose.java:53,
StabiliseTxn.java:35, ExecuteTxn.java:53, Persist.java:43):

  PreAccept (FastPathTracker)
    fast path:  executeAt = txnId, deps = union of fast voters' deps
    slow path:  executeAt = max(witnessedAt), Accept round (Propose), deps
                extended with accept-round deps
  Stabilise+Execute: Commit(Stable) to all replicas, with the read embedded at
    one replica per shard (commit-and-read overlap); stable quorum + data.
  Persist: client callback fires with the Result BEFORE the Apply round --
    Apply is off the latency path (reference: CoordinationAdapter.java:187-192).

Fast path client latency = 2 message round trips; slow path = 3.
"""
from __future__ import annotations

from typing import Dict, Optional

from accord_tpu_torch.coordinate.errors import Exhausted, Preempted, Timeout
from accord_tpu_torch.coordinate.tracking import (
    AppliedTracker, FastPathTracker, QuorumTracker, ReadTracker, RequestStatus,
)
from accord_tpu_torch.messages import (
    Accept, AcceptNack, AcceptOk, AcceptRedundant, Apply, ApplyOk, Callback,
    Commit, CommitOk, PreAccept, PreAcceptNack, PreAcceptOk, ReadNack, ReadOk,
    ReadTxnData,
)
from accord_tpu_torch.obs.trace import REC, node_pid, node_ts
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Ballot, Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_ import AsyncResult
from accord_tpu_torch.utils.invariants import Invariants


class CoordinateTransaction:
    def __init__(self, node, txn_id: TxnId, txn: Txn, route: Route,
                 ballot: Ballot = Ballot.ZERO):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.ballot = ballot  # > ZERO when driven by recovery
        self.result: AsyncResult = AsyncResult()
        self.topologies = node.topology_manager.with_unsynced_epochs(
            route, txn_id.epoch, txn_id.epoch)
        self.execute_at: Optional[Timestamp] = None
        self.deps: Deps = Deps.NONE
        # coordination start in sim microseconds: the txn.commit_latency_us /
        # txn.apply_latency_us histograms and the trace span anchor here
        self.t0_us = node.time_service.now_micros()

    @classmethod
    def coordinate(cls, node, txn_id: TxnId, txn: Txn, route: Route) -> AsyncResult:
        self = cls(node, txn_id, txn, route)
        node.metrics.counter("txn.started").inc()
        if REC.enabled:
            REC.txn_begin(node_pid(node), txn_id, self.t0_us)
        self._start_preaccept()
        return self.result

    @classmethod
    def resume(cls, node, txn_id: TxnId, txn: Txn, route: Route, ballot: Ballot,
               phase: str, execute_at: Timestamp, deps: Deps) -> AsyncResult:
        """Entry point for recovery: re-drive the protocol from `phase`
        ('propose' -> Accept round; 'execute' -> Commit(Stable)+read) with the
        recovery's ballot and reconstructed (executeAt, deps)
        (reference: RecoveryTxnAdapter, coordinate/CoordinationAdapter.java:195)."""
        self = cls(node, txn_id, txn, route, ballot)
        self.execute_at = execute_at
        self.deps = deps
        if phase == "propose":
            self._start_propose()
        else:
            Invariants.check_argument(phase == "execute", "unknown phase %s", phase)
            self._start_execute()
        return self.result

    # -- phase 1: PreAccept --------------------------------------------------
    def _start_preaccept(self) -> None:
        round_ = _PreAcceptRound(self)
        for to in round_.tracker.nodes():
            self.node.send(to, PreAccept(self.txn_id, self.txn, self.route), round_)

    def _on_preaccepted(self, round_: "_PreAcceptRound") -> None:
        from accord_tpu_torch.utils import faults
        if round_.tracker.has_fast_path_accepted() \
                and not faults.FAST_PATH_DISABLED:
            # (reference: CoordinateTransaction.java:73-77)
            self.execute_at = self.txn_id.as_timestamp()
            self.deps = Deps.merge([ok.deps for ok in round_.oks.values()
                                    if ok.is_fast_path_vote])
            self.node.events.on_fast_path_taken(self.txn_id)
            if REC.enabled:
                REC.txn_step(node_pid(self.node), self.txn_id, "fast_path",
                             node_ts(self.node))
            self._start_execute()
        else:
            self.execute_at = _merge_witnessed_all(
                ok.witnessed_at for ok in round_.oks.values())
            self.deps = Deps.merge([ok.deps for ok in round_.oks.values()])
            self.node.events.on_slow_path_taken(self.txn_id)
            if REC.enabled:
                REC.txn_step(node_pid(self.node), self.txn_id, "slow_path",
                             node_ts(self.node))
            if self.execute_at.is_rejected:
                # a replica refused to witness us (behind an
                # ExclusiveSyncPoint floor, or expired): invalidate instead of
                # committing behind the floor (reference:
                # CoordinateTransaction.java:87-89)
                self._invalidate_rejected()
                return
            self._maybe_extend_epochs()

    def _maybe_extend_epochs(self) -> None:
        """ExtraEpochs: a slow-path executeAt in a newer epoch means the new
        epoch's replicas must witness the txn before Accept, and every later
        round must span both replica sets (reference:
        AbstractCoordinatePreAccept.ExtraEpochs, coordinate/
        AbstractCoordinatePreAccept.java:211-238). Loops if the extra round
        pushes executeAt into a yet-newer epoch."""
        target = self.execute_at.epoch
        if target <= self.topologies.current_epoch():
            self._start_propose()
            return

        def cont():
            prev_max = self.topologies.current_epoch()
            self.topologies = self.node.topology_manager.with_unsynced_epochs(
                self.route, self.txn_id.epoch, target)
            extra = self.node.topology_manager.precise_epochs(prev_max + 1, target)
            round_ = _ExtraEpochsRound(self, extra)
            for to in round_.tracker.nodes():
                self.node.send(to, PreAccept(self.txn_id, self.txn, self.route,
                                             min_epoch=target), round_)

        self.node.with_epoch(target, cont)

    def _invalidate_rejected(self) -> None:
        """proposeAndCommitInvalidate at the original coordinator's ballot
        (reference: Propose.Invalidate.proposeAndCommitInvalidate). Safe at
        Ballot.ZERO: only the original coordinator uses ballot zero, and it
        proposes either the txn or the invalidation, never both."""
        from accord_tpu_torch.coordinate.errors import Invalidated
        from accord_tpu_torch.coordinate.recover import propose_invalidate
        from accord_tpu_torch.messages.recover import CommitInvalidate

        def committed(_):
            topology = self.node.topology_manager.for_epoch(self.txn_id.epoch)
            for to in topology.nodes():
                self.node.send(to, CommitInvalidate(self.txn_id,
                                                    self.route.participants))
            self.node.events.on_invalidated(self.txn_id)
            self._fail(Invalidated(f"{self.txn_id} rejected by sync-point floor"))

        propose_invalidate(self.node, self.txn_id, self.ballot,
                           self.route.home_key) \
            .on_success(committed) \
            .on_failure(self._fail)

    # -- phase 2 (slow path): Accept -----------------------------------------
    def _start_propose(self) -> None:
        round_ = _ProposeRound(self)
        for to in round_.tracker.nodes():
            self.node.send(to, Accept(self.txn_id, self.ballot, self.route,
                                      self.txn.keys, self.execute_at,
                                      self.deps), round_)

    def _on_accepted(self, round_: "_ProposeRound") -> None:
        from accord_tpu_torch.utils import faults
        skip = faults.SYNCPOINT_UNMERGED_DEPS \
            if self.txn_id.kind.is_sync_point \
            else faults.TRANSACTION_UNMERGED_DEPS
        if not skip:
            self.deps = Deps.merge(
                [self.deps] + [ok.deps for ok in round_.oks.values()])
        self._start_execute()

    # -- phase 3: Stabilise + Execute (commit-and-read overlap) --------------
    def _start_execute(self) -> None:
        _ExecuteRound(self).start()

    def _on_executed(self, data) -> None:
        writes = self.txn.execute(self.txn_id, self.execute_at, data)
        result = self.txn.result(self.txn_id, self.execute_at, data)
        self._persist(writes, result)

    # -- phase 4: Persist (off the client latency path) ----------------------
    def _persist(self, writes, result) -> None:
        now = node_ts(self.node)
        self.node.metrics.histogram("txn.commit_latency_us").observe(
            now - self.t0_us)
        if REC.enabled:
            REC.txn_step(node_pid(self.node), self.txn_id, "result", now)
        self.result.try_set_success(result)
        round_ = _ApplyRound(self, writes, result)
        round_.start()

    # -- shared failure handling ---------------------------------------------
    def _fail(self, failure: BaseException) -> None:
        if not self.result.done:
            self.node.events.on_timeout(self.txn_id)
            self.node.metrics.counter("txn.failed").inc()
            if REC.enabled:
                REC.txn_end(node_pid(self.node), self.txn_id,
                            node_ts(self.node),
                            args={"failed": type(failure).__name__})
            self.result.set_failure(failure)

    @property
    def done(self) -> bool:
        return self.result.done


def _merge_witnessed_all(timestamps) -> Timestamp:
    """max with sticky rejection across every vote (see
    Timestamp.merge_witnessed)."""
    out = None
    for ts in timestamps:
        out = ts if out is None else Timestamp.merge_witnessed(out, ts)
    Invariants.check_state(out is not None, "no witnessed timestamps")
    return out


class _PreAcceptRound(Callback):
    def __init__(self, parent: CoordinateTransaction):
        self.parent = parent
        self.tracker = FastPathTracker(parent.topologies, parent.txn.keys)
        self.oks: Dict[int, PreAcceptOk] = {}
        self.nacked = False

    def on_success(self, from_node, reply) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        if isinstance(reply, PreAcceptNack):
            # a recovery coordinator holds a higher ballot
            self.nacked = True
            self._handle(self.tracker.on_failure(from_node))
            return
        self.oks[from_node] = reply
        self._handle(self.tracker.on_success(from_node, reply.is_fast_path_vote))

    def on_failure(self, from_node, failure) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        self._handle(self.tracker.on_failure(from_node))

    def _handle(self, status: RequestStatus) -> None:
        if status == RequestStatus.SUCCESS:
            self.parent._on_preaccepted(self)
        elif status == RequestStatus.FAILED:
            self.parent._fail(Preempted(str(self.parent.txn_id)) if self.nacked
                              else Timeout(f"preaccept {self.parent.txn_id}"))


class _ExtraEpochsRound(Callback):
    """PreAccept re-contact of the replicas added by epochs
    (prev_max, executeAt.epoch] (reference: ExtraEpochs.contact)."""

    def __init__(self, parent: CoordinateTransaction, extra_topologies):
        self.parent = parent
        self.tracker = QuorumTracker(extra_topologies, parent.txn.keys)
        self.oks: Dict[int, PreAcceptOk] = {}
        self.nacked = False

    def on_success(self, from_node, reply) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        if isinstance(reply, PreAcceptNack):
            self.nacked = True
            self._handle(self.tracker.on_failure(from_node))
            return
        self.oks[from_node] = reply
        self._handle(self.tracker.on_success(from_node))

    def on_failure(self, from_node, failure) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        self._handle(self.tracker.on_failure(from_node))

    def _handle(self, status: RequestStatus) -> None:
        p = self.parent
        if status == RequestStatus.SUCCESS:
            p.execute_at = _merge_witnessed_all(
                [p.execute_at] + [ok.witnessed_at for ok in self.oks.values()])
            p.deps = Deps.merge([p.deps] + [ok.deps for ok in self.oks.values()])
            if p.execute_at.is_rejected:
                p._invalidate_rejected()
            else:
                p._maybe_extend_epochs()
        elif status == RequestStatus.FAILED:
            p._fail(Preempted(str(p.txn_id)) if self.nacked
                    else Timeout(f"preaccept-extra {p.txn_id}"))


class _ProposeRound(Callback):
    def __init__(self, parent: CoordinateTransaction):
        self.parent = parent
        self.tracker = QuorumTracker(parent.topologies, parent.txn.keys)
        self.oks: Dict[int, AcceptOk] = {}
        self.nacked = False

    def on_success(self, from_node, reply) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        if isinstance(reply, AcceptRedundant):
            # the txn is already COMMITTED (a recovery superseded us, possibly
            # at a different executeAt): committing OUR proposal would hand
            # the client a result computed at the wrong timestamp. Fail as
            # preempted; the cluster already carries the decided outcome.
            self.parent._fail(Preempted(
                f"{self.parent.txn_id} already committed at "
                f"{reply.execute_at}"))
            return
        if isinstance(reply, AcceptNack):
            self.nacked = True
            self._handle(self.tracker.on_failure(from_node))
            return
        self.oks[from_node] = reply
        self._handle(self.tracker.on_success(from_node))

    def on_failure(self, from_node, failure) -> None:
        if self.parent.done or self.tracker.decided is not None:
            return
        self._handle(self.tracker.on_failure(from_node))

    def _handle(self, status: RequestStatus) -> None:
        if status == RequestStatus.SUCCESS:
            self.parent._on_accepted(self)
        elif status == RequestStatus.FAILED:
            self.parent._fail(Preempted(str(self.parent.txn_id)) if self.nacked
                              else Timeout(f"accept {self.parent.txn_id}"))


class _ReadRoundCb(Callback):
    """Round-stamping adapter: _retry_read replaces the read tracker, and a
    late reply/timeout from a previous round must not be credited against
    the NEW tracker (it could mark fresh contacts failed before they
    answer). Stable votes pass through regardless -- they belong to the
    txn, not the read round."""

    __slots__ = ("round_", "target")

    def __init__(self, target: "_ExecuteRound", round_no: int):
        self.target = target
        self.round_ = round_no

    def on_success(self, from_node, reply) -> None:
        self.target.on_success(from_node, reply, self.round_)

    def on_failure(self, from_node, failure) -> None:
        self.target.on_failure(from_node, failure, self.round_)


class _ExecuteRound(Callback):
    """Commit(Stable) to every replica; the read rides on one replica per
    shard (reference: ExecuteTxn.java:84-145 + Commit.stableAndRead)."""

    # a fully-nacked read round is usually TRANSIENT (every replica of some
    # shard awaiting a bootstrap snapshot during churn): retry the read with
    # backoff before giving up (reference: ReadCoordinator retry semantics)
    READ_RETRIES = 4
    READ_RETRY_BACKOFF_MS = 500.0

    def __init__(self, parent: CoordinateTransaction):
        self.parent = parent
        self.stable_tracker = QuorumTracker(parent.topologies, parent.txn.keys)
        read = parent.txn.read
        self.needs_read = read is not None and len(tuple(iter(read.keys()))) > 0
        self.read_tracker = (ReadTracker(parent.topologies, read.keys())
                             if self.needs_read else None)
        self.read_attempts = 0
        self.read_round = 0   # replies from superseded read rounds are
                              # ignored for READ accounting (stable votes
                              # still count -- they are round-independent)
        self.data = None
        self.data_done = not self.needs_read

    def start(self) -> None:
        p = self.parent
        read_targets = (set(self.read_tracker.initial_contacts(prefer=p.node.id))
                        if self.needs_read else set())
        cb = _ReadRoundCb(self, self.read_round)
        for to in self.stable_tracker.nodes():
            p.node.send(to, Commit(p.txn_id, p.route, p.txn, p.execute_at,
                                   p.deps, read=(to in read_targets)), cb)
        self._maybe_done()

    def on_success(self, from_node, reply, round_no: int = 0) -> None:
        p = self.parent
        if p.done:
            return
        current = round_no == self.read_round
        if isinstance(reply, (CommitOk,)):
            self._handle_stable(self.stable_tracker.on_success(from_node))
        elif isinstance(reply, ReadOk):
            if reply.data is not None:
                self.data = reply.data if self.data is None else self.data.merge(reply.data)
            self._handle_stable(self.stable_tracker.on_success(from_node))
            if self.needs_read and not self.data_done and current:
                if reply.unavailable is not None:
                    status, more = self.read_tracker.on_partial_data(
                        from_node, reply.unavailable)
                    self._after_read_step(status, more)
                else:
                    st = self.read_tracker.on_data_success(from_node)
                    if st == RequestStatus.SUCCESS:
                        self.data_done = True
            self._maybe_done()
        elif isinstance(reply, ReadNack):
            # a Commit-with-read replica commits BEFORE attempting the read
            # (Commit.process), so ITS nack is still a stable vote -- and
            # dropping it can leave the stable quorum undecidable with no
            # timeout pending (a silent hang). A bare ReadTxnData nack
            # proves nothing about the commit and must not be credited.
            if reply.committed:
                self._handle_stable(self.stable_tracker.on_success(from_node))
            if current:
                self._read_failure(from_node)

    def on_failure(self, from_node, failure, round_no: int = 0) -> None:
        if self.parent.done:
            return
        self._handle_stable(self.stable_tracker.on_failure(from_node))
        if self.needs_read and round_no == self.read_round:
            self._read_failure(from_node)

    def _read_failure(self, from_node) -> None:
        if self.data_done or self.read_tracker.decided is not None:
            return
        status, more = self.read_tracker.on_read_failure(from_node)
        self._after_read_step(status, more)

    def _after_read_step(self, status: RequestStatus, more) -> None:
        if status == RequestStatus.FAILED:
            if self.read_attempts < self.READ_RETRIES:
                self.read_attempts += 1
                self.parent.node.scheduler.once(
                    self.READ_RETRY_BACKOFF_MS * self.read_attempts,
                    self._retry_read)
            else:
                self.parent._fail(Exhausted(f"read {self.parent.txn_id}"))
            return
        p = self.parent
        cb = _ReadRoundCb(self, self.read_round)
        for to in more:
            p.node.send(to, ReadTxnData(p.txn_id, p.txn, p.execute_at), cb)
        if status == RequestStatus.SUCCESS:
            self.data_done = True
            self._maybe_done()

    def _retry_read(self) -> None:
        """Retry the read round. Escalates to the CURRENT epoch's replicas:
        under churn the txn-epoch replicas may all have lost the data (their
        abandoned bootstrap gaps never heal once the range moved on), while
        the current owners hold the full history. They may never have heard
        of the txn, so the retry rides a (idempotent) Commit-with-read that
        lets them commit, order and serve (the reference's stable-then-read
        escalation)."""
        p = self.parent
        if p.done or self.data_done:
            return
        # CURRENT epoch only: spanning down to txn_id.epoch would still
        # demand data credit from the old shard whose replicas are exactly
        # the ones gap-nacking -- the escalation must be satisfiable by the
        # current owners alone
        epoch = max(p.txn_id.epoch, p.node.epoch)
        topologies = p.node.topology_manager.with_unsynced_epochs(
            p.route, epoch, epoch)
        self.read_round += 1   # retire stale replies from the old round
        self.read_tracker = ReadTracker(topologies, p.txn.read.keys())
        cb = _ReadRoundCb(self, self.read_round)
        for to in self.read_tracker.initial_contacts(prefer=p.node.id):
            p.node.send(to, Commit(p.txn_id, p.route, p.txn, p.execute_at,
                                   p.deps, read=True), cb)

    def _handle_stable(self, status: RequestStatus) -> None:
        if status == RequestStatus.FAILED:
            self.parent._fail(Timeout(f"stabilise {self.parent.txn_id}"))
        else:
            self._maybe_done()

    def _maybe_done(self) -> None:
        if self.parent.done:
            return
        if self.stable_tracker.decided == RequestStatus.SUCCESS and self.data_done:
            self.parent._on_executed(self.data)


class _ApplyRound(Callback):
    """Background persist: broadcast Apply (the client already has its
    result). A couple of retries cover transient drops; beyond that the
    straggler-repair machinery owns convergence -- every replica's progress
    engine tracks stable-but-unapplied commands and fetches the outcome via
    CheckStatus/propagate, and durability rounds advance the floors behind it
    (reference: Persist fire-and-forget + SimpleProgressLog +
    CoordinateDurabilityScheduling)."""

    MAX_ATTEMPTS = 3

    def __init__(self, parent: CoordinateTransaction, writes, result,
                 on_applied=None):
        self.parent = parent
        self.writes = writes
        self.result = result
        self.on_applied = on_applied  # fires once a quorum has applied
        self.tracker = AppliedTracker(parent.topologies, parent.txn.keys)
        self.acked: set = set()
        self.attempts: Dict[int, int] = {}
        self._informed = False

    def _message(self) -> Apply:
        p = self.parent
        return Apply(p.txn_id, p.route, p.txn, p.execute_at, p.deps,
                     self.writes, self.result)

    def start(self) -> None:
        for to in self.tracker.nodes():
            self.attempts[to] = 1
            self.parent.node.send(to, self._message(), self)

    def on_success(self, from_node, reply) -> None:
        self.acked.add(from_node)
        if self.tracker.on_success(from_node) == RequestStatus.SUCCESS:
            self._inform_durable()
            if self.on_applied is not None:
                cb, self.on_applied = self.on_applied, None
                cb()

    def _inform_durable(self) -> None:
        """Applied quorum reached on every shard: broadcast majority-
        durability so progress engines treat the txn as fetch-only work
        (reference: Persist.java:88 sends InformDurable(Majority) to every
        node of the topologies)."""
        if self._informed:
            return
        self._informed = True
        t0 = getattr(self.parent, "t0_us", None)
        if t0 is not None:
            node = self.parent.node
            now = node_ts(node)
            node.metrics.histogram("txn.apply_latency_us").observe(now - t0)
            if REC.enabled:
                REC.txn_end(node_pid(node), self.parent.txn_id, now,
                            args={"acked": len(self.acked)})
        from accord_tpu_torch.local.status import Durability
        from accord_tpu_torch.messages.inform import InformDurable
        p = self.parent
        for to in self.tracker.nodes():
            p.node.counters["informs_durable_sent"] += 1
            p.node.send(to, InformDurable(p.txn_id, p.route, p.execute_at,
                                          Durability.MAJORITY))

    def on_failure(self, from_node, failure) -> None:
        if from_node in self.acked:
            return
        n = self.attempts.get(from_node, 0)
        if n >= self.MAX_ATTEMPTS:
            if self.tracker.on_failure(from_node) == RequestStatus.FAILED \
                    and self.on_applied is not None:
                # a blocking caller (sync point / barrier) is waiting on the
                # applied quorum: fail it rather than hang forever
                self.on_applied = None
                self.parent._fail(Timeout(f"apply {self.parent.txn_id}"))
            return
        self.attempts[from_node] = n + 1
        self.parent.node.send(from_node, self._message(), self)
