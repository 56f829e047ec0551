"""One epoch's shard map (reference: topology/Topology.java:59)."""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from accord_tpu_torch.primitives.keyspace import Key, Keys, Range, Ranges, Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.utils.invariants import Invariants


class Topology:
    __slots__ = ("epoch", "shards", "_starts", "_by_node")

    def __init__(self, epoch: int, shards: Sequence[Shard]):
        self.epoch = epoch
        self.shards: Tuple[Shard, ...] = tuple(sorted(shards, key=lambda s: s.range))
        if Invariants.paranoid():
            for a, b in zip(self.shards, self.shards[1:]):
                Invariants.check_argument(not a.range.intersects(b.range),
                                          "overlapping shards %s %s", a, b)
        self._starts = [s.range.start for s in self.shards]
        by_node: Dict[NodeId, List[Shard]] = {}
        for s in self.shards:
            for n in s.nodes:
                by_node.setdefault(n, []).append(s)
        self._by_node = by_node

    # -- lookup --------------------------------------------------------------
    def nodes(self) -> Tuple[NodeId, ...]:
        return tuple(sorted(self._by_node))

    def shard_for_key(self, key: Key) -> Shard:
        i = bisect_right(self._starts, key) - 1
        Invariants.check_state(i >= 0 and self.shards[i].contains(key),
                               "no shard for key %s in epoch %s", key, self.epoch)
        return self.shards[i]

    def shards_for(self, seekables: Seekables) -> Tuple[Shard, ...]:
        """Shards intersecting the given keys/ranges, in range order."""
        if isinstance(seekables, Keys):
            out, seen = [], set()
            for k in seekables:
                s = self.shard_for_key(k)
                if id(s) not in seen:
                    seen.add(id(s))
                    out.append(s)
            return tuple(out)
        return tuple(s for s in self.shards
                     if any(s.range.intersects(r) for r in seekables))

    def shards_for_route(self, route: Route) -> Tuple[Shard, ...]:
        return self.shards_for(route.participants)

    def for_node(self, node: NodeId) -> Tuple[Shard, ...]:
        return tuple(self._by_node.get(node, ()))

    def ranges_for_node(self, node: NodeId) -> Ranges:
        return Ranges(s.range for s in self._by_node.get(node, ()))

    def ranges(self) -> Ranges:
        return Ranges(_normalized=tuple(s.range for s in self.shards))

    def contains_node(self, node: NodeId) -> bool:
        return node in self._by_node

    def __repr__(self):
        return f"Topology(epoch={self.epoch}, shards={list(self.shards)!r})"
