"""One replicated shard of the key space.

Role-equivalent to the reference's topology/Shard.java:38: a range, its
replica set, and the fast-path electorate, plus the quorum arithmetic the
trackers rely on. The quorum formulas follow the Accord protocol exactly
(Shard.java:71-96):
    max_failures        = (rf - 1) // 2
    slow_quorum         = rf - max_failures           (simple majority)
    fast_quorum         = (max_failures + |E|) // 2 + 1, with |E| >= rf - f
    recovery_fast_path  = (max_failures + 1) // 2
"""
from __future__ import annotations

from typing import FrozenSet, Sequence, Tuple

from accord_tpu_torch.primitives.keyspace import Key, Range
from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.utils.invariants import Invariants


class Shard:
    __slots__ = ("range", "nodes", "fast_path_electorate", "joining",
                 "max_failures", "slow_path_quorum_size", "fast_path_quorum_size",
                 "recovery_fast_path_size")

    def __init__(self, rng: Range, nodes: Sequence[NodeId],
                 fast_path_electorate: FrozenSet[NodeId] = None,
                 joining: FrozenSet[NodeId] = frozenset()):
        self.range = rng
        self.nodes: Tuple[NodeId, ...] = tuple(sorted(nodes))
        electorate = frozenset(fast_path_electorate) if fast_path_electorate is not None \
            else frozenset(self.nodes)
        rf = len(self.nodes)
        f = (rf - 1) // 2
        Invariants.check_argument(len(electorate) >= rf - f,
                                  "electorate %s too small for rf=%s f=%s", electorate, rf, f)
        Invariants.check_argument(electorate <= set(self.nodes), "electorate must be replicas")
        Invariants.check_argument(set(joining) <= set(self.nodes), "joining must be replicas")
        self.fast_path_electorate = electorate
        self.joining = frozenset(joining)
        self.max_failures = f
        self.slow_path_quorum_size = rf - f
        self.fast_path_quorum_size = (f + len(electorate)) // 2 + 1
        self.recovery_fast_path_size = (f + 1) // 2

    @property
    def rf(self) -> int:
        return len(self.nodes)

    def contains(self, key: Key) -> bool:
        return self.range.contains(key)

    def contains_node(self, node: NodeId) -> bool:
        return node in self.nodes

    def rejects_fast_path(self, reject_count: int) -> bool:
        """Has the fast path become impossible given this many electorate
        members voted a different witnessed timestamp?"""
        return reject_count > len(self.fast_path_electorate) - self.fast_path_quorum_size

    def __eq__(self, other):
        return (isinstance(other, Shard) and self.range == other.range
                and self.nodes == other.nodes
                and self.fast_path_electorate == other.fast_path_electorate
                and self.joining == other.joining)

    def __hash__(self):
        return hash((self.range, self.nodes))

    def __repr__(self):
        return f"Shard({self.range!r}, nodes={list(self.nodes)})"
