"""Durability floor propagation.

Role-equivalent to the reference's SetShardDurable / SetGloballyDurable /
QueryDurableBefore (messages/SetShardDurable.java etc., feeding
local/DurableBefore.java:39): after a durability round's ExclusiveSyncPoint
reaches an applied quorum, every replica learns that ids below the sync point
are majority-durable (enabling truncation); a global round aggregates every
node's majority floor into the universal floor.
"""
from __future__ import annotations

from typing import List, Tuple

from accord_tpu_torch.messages.base import Reply, Request
from accord_tpu_torch.primitives.keyspace import Ranges
from accord_tpu_torch.primitives.timestamp import TxnId


class SetShardDurable(Request):
    def __init__(self, sync_id: TxnId, ranges: Ranges):
        self.sync_id = sync_id
        self.ranges = ranges
        self.wait_for_epoch = sync_id.epoch

    def process(self, node, from_node, reply_context) -> None:
        for s in node.command_stores.all():
            if s.owns(self.ranges):
                s.mark_shard_durable(self.sync_id, self.ranges)
        node.reply(from_node, reply_context, DurableAck(self.sync_id))

    def __repr__(self):
        return f"SetShardDurable({self.sync_id!r}, {self.ranges!r})"


class DurableAck(Reply):
    __slots__ = ("sync_id",)

    def __init__(self, sync_id: TxnId):
        self.sync_id = sync_id

    def __repr__(self):
        return f"DurableAck({self.sync_id!r})"


def applied_floor_segments(node) -> List[Tuple]:
    """This node's locally-APPLIED floor segments [(start, end, ts)] across
    its stores (redundant_before): the input to the universal-floor min.
    Shared by the QueryDurableBefore handler and the global coordinator's
    self-reply so the two can never diverge."""
    segments: List[Tuple] = []
    for s in node.command_stores.all():
        for start, end, ts in s.redundant_before.segments():
            if ts is not None:
                segments.append((start, end, ts))
    return segments


class QueryDurableBefore(Request):
    """Collect this node's LOCALLY-APPLIED floor segments (redundant_before:
    everything below an ExclusiveSyncPoint this replica has itself applied).
    The global round takes the per-shard min over replicas: only below that is
    an outcome applied at EVERY replica and safe to erase. Aggregating
    majority floors here instead was the round-2 liveness bug -- replicas
    erased outcomes a straggler still needed."""

    def __init__(self):
        self.wait_for_epoch = 0

    @property
    def has_side_effects(self) -> bool:
        return False

    def process(self, node, from_node, reply_context) -> None:
        node.reply(from_node, reply_context,
                   DurableBeforeOk(applied_floor_segments(node)))

    def __repr__(self):
        return "QueryDurableBefore()"


class DurableBeforeOk(Reply):
    __slots__ = ("segments",)

    def __init__(self, segments: List[Tuple]):
        self.segments = segments  # [(start, end, ts)]

    def __repr__(self):
        return f"DurableBeforeOk({len(self.segments)} segments)"


class SetGloballyDurable(Request):
    """The per-shard min of every replica's locally-applied floor: ids below
    it are applied at EVERY replica (so their records may be erased)."""

    def __init__(self, segments: List[Tuple]):
        self.segments = segments
        self.wait_for_epoch = 0

    def process(self, node, from_node, reply_context) -> None:
        apply_globally_durable(node, self.segments)
        node.reply(from_node, reply_context, DurableAck(None))

    def __repr__(self):
        return f"SetGloballyDurable({len(self.segments)} segments)"


def apply_globally_durable(node, segments: List[Tuple]) -> None:
    """Advance every store's universal floor, then retire topology epochs
    below the floor's minimum epoch (reference: TopologyManager epoch
    truncation via reportEpochRedundant): every txn from those epochs is
    applied at every replica (or can never commit), so coordinations will
    never need their quorums. Shared by the message handler and the global
    coordinator's self-application so both paths retire identically."""
    for s in node.command_stores.all():
        s.mark_globally_durable(segments)
    if not segments:
        return
    # retire ONLY when the floor covers the WHOLE keyspace: a global round
    # can carry a partial segment set (a shard whose replica missed the
    # query contributes nothing), and taking the min over just the present
    # segments would retire epochs a non-durable shard's recovery still
    # needs (its original electorate)
    from accord_tpu_torch.primitives.keyspace import Range, Ranges
    covered = Ranges.EMPTY
    for start, end, _ in segments:
        covered = covered.union(Ranges([Range(start, end)]))
    topology = node.topology_manager.current()
    whole = Ranges([s.range for s in topology.shards])
    if not covered.contains_ranges(whole):
        return
    floor_epoch = min(ts.epoch for _, _, ts in segments)
    node.topology_manager.retire_below(floor_epoch)
