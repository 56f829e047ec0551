"""Execution-phase reads.

Role-equivalent to the reference's ReadData/ReadTxnData
(messages/ReadData.java:53): register as a transient listener on the command,
wait until its local dependencies have applied (READY_TO_EXECUTE), then run
the host Read against the DataStore at executeAt and reply with the Data.
"""
from __future__ import annotations

from typing import List, Optional

from accord_tpu_torch.local.command import TransientListener
from accord_tpu_torch.local.status import Status
from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.keyspace import Keys
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId
from accord_tpu_torch.primitives.txn import Txn
from accord_tpu_torch.utils.async_ import AsyncResult, all_of, success


class ReadOk(Reply):
    """`unavailable` reports the slices this replica could not serve (data
    gaps awaiting a snapshot); the coordinator's ReadTracker credits the
    served shards and escalates the rest (reference: ReadData.ReadOk carries
    `unavailable` Ranges, messages/ReadData.java)."""

    __slots__ = ("txn_id", "data", "unavailable")

    def __init__(self, txn_id: TxnId, data, unavailable=None):
        self.txn_id = txn_id
        self.data = data
        self.unavailable = unavailable

    def __repr__(self):
        return f"ReadOk({self.txn_id!r}, unavailable={self.unavailable})"


class ReadNack(Reply):
    """`committed` distinguishes the two nack sources for the coordinator's
    stable tracker: a nack from a Commit-with-read arrives AFTER the commit
    was processed (a genuine stable vote); a nack from a bare ReadTxnData
    proves nothing about the commit."""

    __slots__ = ("txn_id", "committed")

    def __init__(self, txn_id: TxnId, committed: bool = False):
        self.txn_id = txn_id
        self.committed = committed

    def __repr__(self):
        return f"ReadNack({self.txn_id!r}, committed={self.committed})"


class _ReadWaiter(TransientListener):
    """Waits for READY_TO_EXECUTE (deps applied) then performs this store's
    slice of the read."""

    def __init__(self, store, txn: Txn, execute_at: Timestamp, result: AsyncResult):
        self.store = store
        self.txn = txn
        self.execute_at = execute_at
        self.result = result

    def on_change(self, store, command) -> None:
        if self.result.done:
            command.remove_transient_listener(self)
            return
        if command.is_(Status.INVALIDATED) or command.is_(Status.TRUNCATED):
            command.remove_transient_listener(self)
            self.result.try_set_failure(RuntimeError(f"{command.txn_id} invalidated"))
            return
        if command.is_ready_to_execute():
            command.remove_transient_listener(self)
            # re-check the data gap: a bootstrap that began AFTER this read
            # started waiting elides pending dep edges (set_bootstrap_floor)
            # and wakes us before its snapshot has arrived -- serving those
            # slices now would return data missing acked writes the snapshot
            # carries; serve what is clean, report the rest unavailable
            self.result.try_set_success(
                _do_read(self.store, self.txn, self.execute_at))


def _do_read(store, txn: Txn, execute_at: Timestamp):
    """Read this store's clean slice; returns (data, unavailable Ranges).
    Slices under a data GAP must not be served: the bootstrap snapshot never
    arrived, so deps below its floor were elided without the history being
    present (reference: CommandStore.safeToRead gating + ReadData's
    `unavailable` reporting). A replica that merely LOST a range can still
    serve -- its data below the handover is complete."""
    from accord_tpu_torch.primitives.keyspace import Ranges
    data = None
    read_keys = txn.read.keys() if txn.read is not None else None
    if read_keys is None:
        return None, Ranges.EMPTY
    owned = store.owned(read_keys)
    if len(owned) == 0:
        return None, Ranges.EMPTY
    is_range_read = isinstance(owned, Ranges)
    owned_ranges = owned if is_range_read else owned.to_ranges()
    gapped = owned_ranges.intersection(store.data_gaps)
    if is_range_read:
        targets = owned.difference(gapped) if not gapped.is_empty() else owned
    else:
        targets = owned if gapped.is_empty() else \
            (k for k in owned if not gapped.contains_key(k))
    for t in targets:
        d = txn.read.read(t, store, execute_at)
        if d is not None:
            data = d if data is None else data.merge(d)
    return data, gapped


def _read_one_store(store, txn_id: TxnId, txn: Txn, execute_at: Timestamp) -> AsyncResult:
    out: AsyncResult = AsyncResult()
    cmd = store.command(txn_id)
    if cmd.is_ready_to_execute():
        out.set_success(_do_read(store, txn, execute_at))
    elif cmd.is_(Status.INVALIDATED) or cmd.is_(Status.TRUNCATED):
        out.set_failure(RuntimeError(f"{txn_id} invalidated"))
    else:
        cmd.add_transient_listener(_ReadWaiter(store, txn, execute_at, out))
    return out


def _reply_merged_read(node, txn_id: TxnId, from_node, reply_context,
                       results) -> None:
    """Merge per-store (data, unavailable) results into one ReadOk."""
    from accord_tpu_torch.primitives.keyspace import Ranges
    data = None
    unavailable = Ranges.EMPTY
    for d, unav in results:
        if d is not None:
            data = d if data is None else data.merge(d)
        unavailable = unavailable.union(unav)
    node.reply(from_node, reply_context,
               ReadOk(txn_id, data,
                      unavailable if not unavailable.is_empty() else None))


def execute_read_when_ready(node, txn_id: TxnId, txn: Txn, execute_at: Timestamp,
                            from_node, reply_context,
                            committed: bool = False) -> None:
    stores = node.command_stores.intersecting(txn.keys)
    waits = [_read_one_store(s, txn_id, txn, execute_at) for s in stores]

    all_of(waits) \
        .on_success(lambda results: _reply_merged_read(
            node, txn_id, from_node, reply_context, results)) \
        .on_failure(lambda _: node.reply(from_node, reply_context,
                                         ReadNack(txn_id, committed)))


class ReadTxnData(Request):
    """Standalone read request (retry path when the committing replica's
    embedded read failed or a different replica is tried)."""

    def __init__(self, txn_id: TxnId, txn: Txn, execute_at: Timestamp):
        self.txn_id = txn_id
        self.txn = txn
        self.execute_at = execute_at
        self.wait_for_epoch = max(txn_id.epoch, execute_at.epoch)

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        execute_read_when_ready(node, self.txn_id, self.txn, self.execute_at,
                                from_node, reply_context)

    def __repr__(self):
        return f"ReadTxnData({self.txn_id!r})"


class EphemeralRead(Request):
    """Execute an ephemeral read: wait until every (floor-elided) dep has
    applied locally, then read CURRENT state -- no command record, no
    registration, nothing persisted (reference: ReadData's
    readDataWithoutTimestamp mode + ReadEphemeralTxnData,
    messages/ReadData.java:61-90). Blocked deps are reported to the progress
    log so recovery unwedges them exactly as for managed reads."""

    def __init__(self, txn_id: TxnId, txn: Txn, deps, execute_epoch: int):
        self.txn_id = txn_id
        self.txn = txn
        self.deps = deps
        # wait until this replica knows the epoch it was selected from --
        # processing earlier could find no owning store and reply an empty
        # (falsely complete) result
        self.wait_for_epoch = max(txn_id.epoch, execute_epoch)

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        from accord_tpu_torch.local import commands as _commands
        stores = [s for s in node.command_stores.intersecting(self.txn.keys)
                  if len(s.owned(self.txn.keys)) > 0]
        if not stores:
            # nothing owned here (mid-handover): nack so the tracker
            # escalates rather than crediting an empty result
            node.reply(from_node, reply_context, ReadNack(self.txn_id))
            return
        waits = []
        for store in stores:
            out: AsyncResult = AsyncResult()
            waits.append(out)
            sliced = self.deps.slice(store.ranges)
            needed = _commands.needed_dep_ids_for(store, sliced, self.txn_id)
            pending = []
            for dep_id in sorted(needed):
                dep = store.command(dep_id)
                if dep.has_been(Status.APPLIED) or dep.status.is_terminal:
                    continue
                pending.append(dep_id)
            if not pending:
                out.try_set_success(_do_read(store, self.txn, Timestamp.MAX))
                continue
            remaining = {"n": len(pending)}

            class _DepWaiter(TransientListener):
                def __init__(self, s=store, o=out, r=remaining, t=self.txn):
                    self.s, self.o, self.r, self.t = s, o, r, t

                def on_change(self, s, command) -> None:
                    if self.o.done:
                        command.remove_transient_listener(self)
                        return
                    if command.has_been(Status.APPLIED) \
                            or command.status.is_terminal:
                        command.remove_transient_listener(self)
                        self.r["n"] -= 1
                        if self.r["n"] == 0:
                            self.o.try_set_success(
                                _do_read(self.s, self.t, Timestamp.MAX))

            for dep_id in pending:
                dep = store.command(dep_id)
                dep.add_transient_listener(_DepWaiter())
                store.progress_log.waiting(
                    dep_id, Status.APPLIED, sliced.participants_of(dep_id))

        all_of(waits) \
            .on_success(lambda results: _reply_merged_read(
                node, self.txn_id, from_node, reply_context, results)) \
            .on_failure(lambda _: node.reply(from_node, reply_context,
                                             ReadNack(self.txn_id)))

    def __repr__(self):
        return f"EphemeralRead({self.txn_id!r})"
