"""Routes: where a transaction must be coordinated.

Role-equivalent to the reference's Route family (primitives/Route.java:25,
FullKeyRoute/PartialKeyRoute/...): the set of participating keys/ranges plus a
designated *home key* whose shard owns the transaction's liveness (progress
log / recovery responsibility). We collapse the reference's 4-way Full/Partial
x Key/Range class matrix into one class with a `full` flag and Seekables
participants; domain dispatch rides on the participants' own domain tag.
"""
from __future__ import annotations

from typing import Optional, Union

from accord_tpu_torch.primitives.keyspace import Key, Keys, Range, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import Domain


class Route:
    __slots__ = ("home_key", "participants", "full")

    def __init__(self, home_key: Key, participants: Seekables, full: bool = True):
        self.home_key = home_key
        self.participants = participants
        self.full = full

    @classmethod
    def of(cls, home_key: Key, participants: Seekables) -> "Route":
        return cls(home_key, participants, full=True)

    @property
    def domain(self) -> Domain:
        return self.participants.domain

    def covering(self) -> Ranges:
        """Ranges covered by the participants."""
        if isinstance(self.participants, Ranges):
            return self.participants
        return self.participants.to_ranges()

    def slice(self, ranges: Ranges) -> "Route":
        sliced = self.participants.slice(ranges)
        is_full = self.full and sliced == self.participants
        return Route(self.home_key, sliced, full=is_full)

    def union(self, other: "Route") -> "Route":
        assert self.home_key == other.home_key
        return Route(self.home_key, self.participants.union(other.participants),
                     full=self.full or other.full)

    def intersects(self, ranges: Ranges) -> bool:
        return self.participants.intersects(ranges)

    def contains(self, key: Key) -> bool:
        if isinstance(self.participants, Ranges):
            return self.participants.contains_key(key)
        return key in self.participants

    def is_empty(self) -> bool:
        return self.participants.is_empty()

    def __eq__(self, other):
        return (isinstance(other, Route) and self.home_key == other.home_key
                and self.participants == other.participants and self.full == other.full)

    def __hash__(self):
        return hash((self.home_key, self.participants, self.full))

    def __repr__(self):
        return f"Route(home={self.home_key}, {self.participants!r}, full={self.full})"
