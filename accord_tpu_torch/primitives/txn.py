"""Transactions (reference: primitives/Txn.java:53, PartialTxn.java).

A Txn bundles the keys/ranges it touches with host-supplied execution SPI
objects (Read/Update/Query from accord_tpu_torch.api): the protocol engine never
interprets data, it only orders and schedules.
"""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.primitives.keyspace import Keys, Ranges, Seekables
from accord_tpu_torch.primitives.routes import Route
from accord_tpu_torch.primitives.timestamp import Domain, Timestamp, TxnId, TxnKind


class Txn:
    __slots__ = ("kind", "keys", "read", "update", "query")

    def __init__(self, kind: TxnKind, keys: Seekables, read=None, update=None, query=None):
        self.kind = kind
        self.keys = keys      # Keys or Ranges
        self.read = read      # api.Read
        self.update = update  # api.Update | None
        self.query = query    # api.Query | None

    @property
    def domain(self) -> Domain:
        return self.keys.domain

    def to_route(self, home_key) -> Route:
        return Route.of(home_key, self.keys)

    def slice(self, ranges: Ranges, include_query: bool) -> "PartialTxn":
        sliced = self.keys.slice(ranges)
        return PartialTxn(
            self.kind, sliced, covering=ranges,
            read=self.read.slice(ranges) if self.read is not None else None,
            update=self.update.slice(ranges) if self.update is not None else None,
            query=self.query if include_query else None,
        )

    def intersects(self, ranges: Ranges) -> bool:
        return self.keys.intersects(ranges)

    def execute(self, txn_id: TxnId, execute_at: Timestamp, data):
        """Compute the Writes from collected read Data (coordinator side)."""
        from accord_tpu_torch.primitives.writes import Writes
        if self.update is None:
            return None
        write = self.update.apply(execute_at, data)
        return Writes(txn_id, execute_at, self.update.keys(), write)

    def result(self, txn_id: TxnId, execute_at: Timestamp, data):
        if self.query is None:
            return None
        return self.query.compute(txn_id, execute_at, self.keys, data, self.read, self.update)

    def __repr__(self):
        return f"Txn({self.kind.name}, {self.keys!r})"


class PartialTxn(Txn):
    """A Txn sliced to the ranges one replica/store owns."""

    __slots__ = ("covering",)

    def __init__(self, kind: TxnKind, keys: Seekables, covering: Ranges,
                 read=None, update=None, query=None):
        super().__init__(kind, keys, read, update, query)
        self.covering = covering

    def covers(self, ranges: Ranges) -> bool:
        return self.covering.contains_ranges(ranges)

    def union(self, other: "PartialTxn") -> "PartialTxn":
        """Merge two slices (reference: PartialTxn.java:70-72 -- read/update
        are MERGED, not first-wins, or the second slice's coverage is lost)."""
        assert self.kind == other.kind, f"kind mismatch {self.kind} vs {other.kind}"
        return PartialTxn(
            self.kind, self.keys.union(other.keys),
            covering=self.covering.union(other.covering),
            read=_merge_part(self.read, other.read),
            update=_merge_part(self.update, other.update),
            query=self.query if self.query is not None else other.query,
        )

    def reconstitute(self) -> Txn:
        return Txn(self.kind, self.keys, self.read, self.update, self.query)


def _merge_part(a, b):
    if a is None:
        return b
    if b is None or a is b:
        return a
    return a.merge(b)
