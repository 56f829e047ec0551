"""Applied side-effects of a transaction (reference: primitives/Writes.java:32)."""
from __future__ import annotations

from typing import Optional

from accord_tpu_torch.primitives.keyspace import Keys, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class Writes:
    __slots__ = ("txn_id", "execute_at", "keys", "write")

    def __init__(self, txn_id: TxnId, execute_at: Timestamp, keys: Seekables, write):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.keys = keys
        self.write = write  # api.Write

    def apply_to(self, safe_store, ranges: Ranges):
        """Apply this write to every owned key (replica side)."""
        if self.write is None:
            return
        if isinstance(self.keys, Keys):
            for key in self.keys:
                if ranges.contains_key(key):
                    self.write.apply(key, safe_store, self.execute_at)
        else:
            self.write.apply_ranges(self.keys.slice(ranges), safe_store, self.execute_at)

    def slice(self, ranges: Ranges) -> "Writes":
        return Writes(self.txn_id, self.execute_at, self.keys.slice(ranges), self.write)

    def union(self, other: Optional["Writes"]) -> "Writes":
        """Merge two slices of the same logical Writes (status-probe replies
        arrive as per-store slices; losing a slice loses writes)."""
        if other is None:
            return self
        assert self.txn_id == other.txn_id and self.execute_at == other.execute_at
        write = self.write if self.write is not None else other.write
        if self.write is not None and other.write is not None \
                and self.write is not other.write:
            merge = getattr(self.write, "merge", None)
            if merge is not None:
                try:
                    write = merge(other.write)
                except NotImplementedError:
                    pass  # write objects carry full state; either slice works
        return Writes(self.txn_id, self.execute_at,
                      self.keys.union(other.keys), write)

    def __repr__(self):
        return f"Writes({self.txn_id!r}@{self.execute_at!r}, {self.keys!r})"
