"""Durability rounds: background coordination that advances the durable
floors and enables truncation.

Role-equivalent to the reference's CoordinateDurabilityScheduling
(impl/CoordinateDurabilityScheduling.java:53-77, doc: nodes take wall-clock
round-robin turns running CoordinateShardDurable over sub-ranges, and
occasionally CoordinateGloballyDurable) plus the CoordinateShardDurable /
CoordinateGloballyDurable coordinations themselves.

A shard-durable round: coordinate an ExclusiveSyncPoint over a shard's range,
wait for an APPLIED quorum (everything ordered below the sync point is then
applied at a quorum), then broadcast SetShardDurable so every replica advances
its majority floor and truncates. A global round aggregates every replica's
locally-APPLIED floor (redundant_before) into the universal floor via
QueryDurableBefore / SetGloballyDurable -- only below the min over every
replica is an outcome erasable (see QueryDurableBefore doc).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from accord_tpu_torch.coordinate.syncpoint import CoordinateSyncPoint
from accord_tpu_torch.messages.base import Callback
from accord_tpu_torch.messages.durability import (
    DurableBeforeOk, QueryDurableBefore, SetGloballyDurable, SetShardDurable,
    applied_floor_segments,
)
from accord_tpu_torch.primitives.keyspace import Ranges
from accord_tpu_torch.primitives.timestamp import Timestamp
from accord_tpu_torch.utils.async_ import AsyncResult


class CoordinateShardDurable:
    """One durability round over `ranges` (reference:
    coordinate/CoordinateShardDurable.java)."""

    @classmethod
    def run(cls, node, ranges: Ranges) -> AsyncResult:
        out: AsyncResult = AsyncResult()

        def on_applied_quorum(sp):
            # everything below sp.sync_id on these ranges is applied at a
            # quorum: tell every replica
            topology = node.topology_manager.current()
            targets = set()
            for shard in topology.shards_for(ranges):
                targets.update(shard.nodes)
            for to in sorted(targets):
                if to == node.id:
                    for s in node.command_stores.all():
                        if s.owns(ranges):
                            s.mark_shard_durable(sp.sync_id, ranges)
                else:
                    node.send(to, SetShardDurable(sp.sync_id, ranges))
            out.try_set_success(sp.sync_id)

        CoordinateSyncPoint.exclusive(node, ranges, blocking=True) \
            .on_success(on_applied_quorum) \
            .on_failure(out.try_set_failure)
        return out


class CoordinateGloballyDurable(Callback):
    """Aggregate every replica's majority floor into the universal floor
    (reference: coordinate/CoordinateGloballyDurable.java)."""

    def __init__(self, node):
        self.node = node
        self.topology = node.topology_manager.current()
        self.replies: Dict[int, DurableBeforeOk] = {}
        self.pending = set(self.topology.nodes())
        self.result: AsyncResult = AsyncResult()

    @classmethod
    def run(cls, node) -> AsyncResult:
        self = cls(node)
        for to in sorted(self.pending):
            if to == node.id:
                self.replies[to] = DurableBeforeOk(applied_floor_segments(node))
                self.pending.discard(to)
            else:
                node.send(to, QueryDurableBefore(), self)
        self._maybe_finish()
        return self.result

    def on_success(self, from_node, reply) -> None:
        if isinstance(reply, DurableBeforeOk):
            self.replies[from_node] = reply
        self.pending.discard(from_node)
        self._maybe_finish()

    def on_failure(self, from_node, failure) -> None:
        # global rounds are best-effort: a missing node just means no
        # universal advance where it replicates
        self.pending.discard(from_node)
        self._maybe_finish()

    def _maybe_finish(self) -> None:
        if self.pending or self.result.done:
            return
        # per current shard: universal floor = min over its replicas' floors
        # (absent any replica's coverage = no advance there)
        from accord_tpu_torch.utils.range_map import ReducingRangeMap, min_intersection
        per_node: Dict[int, ReducingRangeMap] = {}
        for nid, ok in self.replies.items():
            m = ReducingRangeMap.EMPTY
            for start, end, ts in ok.segments:
                m = m.with_range(start, end, ts, Timestamp.merge_max)
            per_node[nid] = m
        out_segments: List[Tuple] = []
        for shard in self.topology.shards:
            floor: Optional[ReducingRangeMap] = None
            missing = False
            for nid in shard.nodes:
                m = per_node.get(nid)
                if m is None or m.is_empty():
                    missing = True
                    break
                floor = m if floor is None else min_intersection(floor, m)
            if missing or floor is None:
                continue
            for start, end, ts in floor.segments():
                if ts is None:
                    continue
                s = max(start, shard.range.start)
                e = min(end, shard.range.end)
                if s < e:
                    out_segments.append((s, e, ts))
        if out_segments:
            from accord_tpu_torch.messages.durability import apply_globally_durable
            for to in self.topology.nodes():
                if to == self.node.id:
                    apply_globally_durable(self.node, out_segments)
                else:
                    self.node.send(to, SetGloballyDurable(out_segments))
        self.result.try_set_success(len(out_segments))


class DurabilityScheduling:
    """Round-robin background rotation (reference:
    impl/CoordinateDurabilityScheduling.java:77): each interval slot belongs
    to one node (by index in the current topology's node list); on its turn a
    node runs a shard-durable round over the next shard in rotation, and
    every `global_every` of its turns also a global round."""

    def __init__(self, node, interval_ms: float = 500.0, global_every: int = 4,
                 should_stop=None):
        self.node = node
        self.interval_ms = interval_ms
        self.global_every = global_every
        self.should_stop = should_stop  # sim quiescence: stop rescheduling
        self.shard_cursor = 0
        self.turns = 0
        self.stopped = False
        self._in_flight = False

    def start(self) -> None:
        self.node.scheduler.once(self.interval_ms, self._tick)

    def stop(self) -> None:
        self.stopped = True

    def _tick(self) -> None:
        if self.stopped or (self.should_stop is not None and self.should_stop()):
            return
        try:
            self._maybe_run()
        finally:
            self.node.scheduler.once(self.interval_ms, self._tick)

    def _maybe_run(self) -> None:
        if self._in_flight:
            return
        topology = self.node.topology_manager.current()
        nodes = sorted(topology.nodes())
        if self.node.id not in nodes:
            return
        slot = int(self.node.now_millis() // self.interval_ms) % len(nodes)
        if nodes[slot] != self.node.id:
            return
        self.turns += 1
        shard = topology.shards[self.shard_cursor % len(topology.shards)]
        self.shard_cursor += 1
        self._in_flight = True

        def done(value, failure):
            self._in_flight = False

        CoordinateShardDurable.run(self.node, Ranges.of(shard.range)) \
            .add_callback(done)
        if self.turns % self.global_every == 0:
            CoordinateGloballyDurable.run(self.node)
