"""A contiguous run of epochs a transaction spans (reference:
topology/Topologies.java:39). Trackers account responses per shard per epoch;
a coordination must reach quorum in EVERY epoch it spans."""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

from accord_tpu_torch.primitives.timestamp import NodeId
from accord_tpu_torch.topology.shard import Shard
from accord_tpu_torch.topology.topology import Topology
from accord_tpu_torch.utils.invariants import Invariants


class Topologies:
    __slots__ = ("topologies",)

    def __init__(self, topologies: Sequence[Topology]):
        """topologies ordered newest-first (reference convention)."""
        Invariants.check_argument(len(topologies) > 0, "empty topologies")
        if Invariants.paranoid():
            for a, b in zip(topologies, topologies[1:]):
                Invariants.check_argument(a.epoch == b.epoch + 1,
                                          "non-contiguous epochs %s %s", a.epoch, b.epoch)
        self.topologies = tuple(topologies)

    @classmethod
    def single(cls, topology: Topology) -> "Topologies":
        return cls((topology,))

    def current(self) -> Topology:
        return self.topologies[0]

    def oldest(self) -> Topology:
        return self.topologies[-1]

    def current_epoch(self) -> int:
        return self.topologies[0].epoch

    def oldest_epoch(self) -> int:
        return self.topologies[-1].epoch

    def for_epoch(self, epoch: int) -> Topology:
        i = self.topologies[0].epoch - epoch
        Invariants.check_argument(0 <= i < len(self.topologies), "epoch %s not covered", epoch)
        return self.topologies[i]

    def contains_epoch(self, epoch: int) -> bool:
        return self.oldest_epoch() <= epoch <= self.current_epoch()

    def __len__(self) -> int:
        return len(self.topologies)

    def __iter__(self):
        return iter(self.topologies)

    def nodes(self) -> Tuple[NodeId, ...]:
        out = set()
        for t in self.topologies:
            out.update(t.nodes())
        return tuple(sorted(out))

    def __repr__(self):
        return f"Topologies({[t.epoch for t in self.topologies]})"
