"""Ephemeral reads: linearizable reads with no durable protocol state.

Role-equivalent to the reference's CoordinateEphemeralRead +
ExecuteEphemeralRead (coordinate/CoordinateEphemeralRead.java,
messages/GetEphemeralReadDeps.java): collect every witnessed conflict from a
quorum of each shard (no timestamp bound), then read from one replica per
shard once those deps have applied there. The read itself is never
PreAccepted/committed/persisted -- other transactions can never depend on
it, and a client timeout simply abandons it (there is nothing to recover).

Guarantee (mirrors the reference's doc): strict-serializable for single-key
reads; per-key linearizable for multi-key reads (the burn generates only
single-key ephemeral reads so the strict verifier applies in full).
"""
from __future__ import annotations

from typing import List

from accord_tpu_torch.coordinate.errors import Exhausted, Timeout
from accord_tpu_torch.coordinate.tracking import QuorumTracker, ReadTracker, RequestStatus
from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.getdeps import GetEphemeralReadDeps, GetEphemeralReadDepsOk
from accord_tpu_torch.messages.read import EphemeralRead, ReadNack, ReadOk
from accord_tpu_torch.primitives.deps import Deps
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_ import AsyncResult


class CoordinateEphemeralRead(Callback):
    def __init__(self, node, txn_id: TxnId, txn: Txn, route):
        self.node = node
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.result: AsyncResult = AsyncResult()
        self.collected_epoch = txn_id.epoch
        self.topologies = node.topology_manager.with_unsynced_epochs(
            route, txn_id.epoch, txn_id.epoch)
        self.tracker = QuorumTracker(self.topologies, txn.keys)
        self.oks: List[GetEphemeralReadDepsOk] = []
        self.latest_epoch = txn_id.epoch
        self.chases = 0
        self.executing = False
        self.round = 0

    MAX_EPOCH_CHASES = 3

    @classmethod
    def coordinate(cls, node, txn_id: TxnId, txn: Txn, route) -> AsyncResult:
        self = cls(node, txn_id, txn, route)
        self._send_round()
        return self.result

    def _send_round(self) -> None:
        # each deps round gets its own callback stamped with the round number
        # so late replies/timeouts from a superseded round (after an epoch
        # chase replaced the tracker) are never credited against the new
        # QuorumTracker -- the same cross-round crediting hazard
        # transaction.py's _ReadRoundCb guards
        cb = _DepsRoundCb(self, self.round)
        for to in self.tracker.nodes():
            self.node.send(to, GetEphemeralReadDeps(self.txn_id, self.txn.keys),
                           cb)

    # -- deps collection ------------------------------------------------------
    def on_round_success(self, round_no, from_node, reply) -> None:
        if self.result.done or self.executing or round_no != self.round:
            return
        self.oks.append(reply)
        self.latest_epoch = max(self.latest_epoch, reply.latest_epoch)
        if self.tracker.on_success(from_node) == RequestStatus.SUCCESS:
            self._quorum_reached()

    def on_round_failure(self, round_no, from_node, failure) -> None:
        if self.result.done or self.executing or round_no != self.round:
            return
        if self.tracker.on_failure(from_node) == RequestStatus.FAILED:
            self.result.try_set_failure(
                Timeout(f"ephemeral deps {self.txn_id}"))

    def _quorum_reached(self) -> None:
        # epoch chase (reference: CoordinateEphemeralRead re-contacts when
        # replies report a later epoch): deps must come from quorums of the
        # epoch the read will execute in, else a write witnessed only by
        # new-epoch replicas could be missed
        if self.latest_epoch > self.collected_epoch:
            if self.chases >= self.MAX_EPOCH_CHASES:
                # deps from a stale-epoch quorum must NOT execute against the
                # newer topology (a new-epoch-only write could be missed):
                # abandon -- the client retries with a fresh txn id
                self.result.try_set_failure(Timeout(
                    f"ephemeral {self.txn_id}: epochs outran "
                    f"{self.MAX_EPOCH_CHASES} deps rounds"))
                return
            self.chases += 1
            target = self.latest_epoch

            def rerun():
                self.collected_epoch = target
                self.round += 1  # invalidate the superseded round's callbacks
                self.topologies = self.node.topology_manager \
                    .with_unsynced_epochs(self.route, target, target)
                self.tracker = QuorumTracker(self.topologies, self.txn.keys)
                self._send_round()

            self.node.with_epoch(target, rerun)
            return
        self._execute()

    # -- execution ------------------------------------------------------------
    def _execute(self) -> None:
        self.executing = True
        deps = Deps.merge([ok.deps for ok in self.oks])
        node = self.node
        epoch = max(self.latest_epoch, self.txn_id.epoch)

        def start(_=None):
            topologies = node.topology_manager.with_unsynced_epochs(
                self.route, epoch, epoch)
            _EphemeralExecute(self, topologies, deps, epoch).start()

        if epoch > node.epoch:
            node.with_epoch(epoch, start)
        else:
            start()


class _DepsRoundCb(Callback):
    """Round-stamped adapter: replies from a superseded deps round must not
    credit the tracker of the round that replaced it."""

    __slots__ = ("parent", "round_no")

    def __init__(self, parent: CoordinateEphemeralRead, round_no: int):
        self.parent = parent
        self.round_no = round_no

    def on_success(self, from_node, reply) -> None:
        self.parent.on_round_success(self.round_no, from_node, reply)

    def on_failure(self, from_node, failure) -> None:
        self.parent.on_round_failure(self.round_no, from_node, failure)


class _EphemeralExecute(Callback):
    """Read round: one replica per shard, escalating on nacks/gaps."""

    def __init__(self, parent: CoordinateEphemeralRead, topologies, deps: Deps,
                 epoch: int):
        self.parent = parent
        self.deps = deps
        self.epoch = epoch
        self.read_tracker = ReadTracker(topologies, parent.txn.read.keys())
        self.data = None
        self.done = False

    def start(self) -> None:
        p = self.parent
        for to in self.read_tracker.initial_contacts(prefer=p.node.id):
            p.node.send(to, EphemeralRead(p.txn_id, p.txn, self.deps,
                                          self.epoch), self)

    def on_success(self, from_node, reply) -> None:
        if self.done or self.parent.result.done:
            return
        if isinstance(reply, ReadNack):
            self._step(*self.read_tracker.on_read_failure(from_node))
            return
        assert isinstance(reply, ReadOk)
        if reply.data is not None:
            self.data = reply.data if self.data is None \
                else self.data.merge(reply.data)
        if reply.unavailable is not None:
            self._step(*self.read_tracker.on_partial_data(
                from_node, reply.unavailable))
        else:
            st = self.read_tracker.on_data_success(from_node)
            if st == RequestStatus.SUCCESS:
                self._finish()

    def on_failure(self, from_node, failure) -> None:
        if self.done or self.parent.result.done:
            return
        self._step(*self.read_tracker.on_read_failure(from_node))

    def _step(self, status: RequestStatus, more) -> None:
        p = self.parent
        if status == RequestStatus.FAILED:
            self.done = True
            p.result.try_set_failure(Exhausted(f"ephemeral read {p.txn_id}"))
            return
        for to in more:
            p.node.send(to, EphemeralRead(p.txn_id, p.txn, self.deps,
                                          self.epoch), self)
        if status == RequestStatus.SUCCESS:
            self._finish()

    def _finish(self) -> None:
        self.done = True
        p = self.parent
        result = p.txn.query.compute(p.txn_id, p.txn_id.as_timestamp(),
                                     p.txn.keys, self.data, p.txn.read, None)
        p.result.try_set_success(result)
