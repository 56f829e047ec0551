"""The list-store workload oracle.

Role-equivalent to the reference's impl/list model (test impl/list/
ListStore.java, ListRead/ListUpdate/ListQuery/ListResult): each key holds an
append-only list of unique ints; writes append their value at executeAt,
reads return the list as of executeAt. Because values are unique and appends
are totally ordered by executeAt, observed lists directly expose the
serialization order for the verifier.
"""
from __future__ import annotations

from bisect import insort
from typing import Dict, Optional, Tuple

from accord_tpu_torch import api
from accord_tpu_torch.primitives.keyspace import Keys, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId


class ListData(api.Data):
    def __init__(self, entries: Dict[object, Tuple[int, ...]]):
        self.entries = dict(entries)

    def merge(self, other: "ListData") -> "ListData":
        merged = dict(self.entries)
        for k, v in other.entries.items():
            if k not in merged or len(v) > len(merged[k]):
                merged[k] = v
        return ListData(merged)

    def __repr__(self):
        return f"ListData({self.entries!r})"


class ListStore(api.DataStore):
    """Per-node storage: key -> sorted list of (executeAt, value)."""

    def __init__(self):
        self.data: Dict[object, list] = {}

    def read_at(self, key, at: Timestamp) -> Tuple[int, ...]:
        entries = self.data.get(key, [])
        return tuple(v for ts, v in entries if ts < at)

    def append(self, key, at: Timestamp, value: int) -> None:
        entries = self.data.setdefault(key, [])
        for ts, v in entries:
            if v == value:
                if ts != at:
                    raise AssertionError(
                        f"value {value} applied twice to key {key} at "
                        f"different executeAts: {ts} vs {at}")
                return  # idempotent re-apply: a bootstrap snapshot may
                        # already contain an ABOVE-floor txn's effect (the
                        # source applied it before snapshotting), and the txn
                        # then also applies individually
        insort(entries, (at, value))

    def snapshot(self, key) -> Tuple[int, ...]:
        return tuple(v for _, v in self.data.get(key, []))

    def merge_entries(self, fetched: Dict[object, Tuple]) -> None:
        """Union a bootstrap-fetched snapshot into local storage; entries are
        (executeAt, value) pairs so the union is idempotent and order-free."""
        for key, entries in fetched.items():
            cur = self.data.setdefault(key, [])
            existing = set(cur)
            for e in entries:
                if e not in existing:
                    insort(cur, e)
                    existing.add(e)


class ListRead(api.Read):
    def __init__(self, keys: Keys):
        self._keys = keys

    def keys(self) -> Keys:
        return self._keys

    def read(self, key, store, execute_at: Timestamp) -> Optional[ListData]:
        data_store: ListStore = store.node.data_store
        return ListData({key: data_store.read_at(key, execute_at)})

    def slice(self, ranges: Ranges) -> "ListRead":
        return ListRead(self._keys.slice(ranges))

    def merge(self, other: "ListRead") -> "ListRead":
        return ListRead(self._keys.union(other._keys))


class ListRangeRead(api.Read):
    """Range-domain read: returns every key's list within the ranges as of
    executeAt (the reference burn's range reads, BurnTest.java:123)."""

    def __init__(self, ranges: Ranges):
        self._ranges = ranges

    def keys(self) -> Ranges:
        return self._ranges

    def read(self, rng, store, execute_at: Timestamp) -> Optional[ListData]:
        data_store: ListStore = store.node.data_store
        out = {}
        for key in data_store.data:
            if rng.contains(key):
                out[key] = data_store.read_at(key, execute_at)
        return ListData(out)

    def slice(self, ranges: Ranges) -> "ListRangeRead":
        return ListRangeRead(self._ranges.intersection(ranges))

    def merge(self, other: "ListRangeRead") -> "ListRangeRead":
        return ListRangeRead(self._ranges.union(other._ranges))


class ListWrite(api.Write):
    def __init__(self, appends: Dict[object, int]):
        self.appends = appends

    def apply(self, key, store, execute_at: Timestamp) -> None:
        if key in self.appends:
            data_store: ListStore = store.node.data_store
            data_store.append(key, execute_at, self.appends[key])


class ListUpdate(api.Update):
    """Append `value` to each key in keys."""

    def __init__(self, keys: Keys, value: int):
        self._keys = keys
        self.value = value

    def keys(self) -> Keys:
        return self._keys

    def apply(self, execute_at: Timestamp, data) -> ListWrite:
        return ListWrite({k: self.value for k in self._keys})

    def slice(self, ranges: Ranges) -> "ListUpdate":
        return ListUpdate(self._keys.slice(ranges), self.value)

    def merge(self, other: "ListUpdate") -> "ListUpdate":
        assert self.value == other.value
        return ListUpdate(self._keys.union(other._keys), self.value)


class ListRangeWrite(api.Write):
    """Range-domain write: append `appends[k]` to every target key that
    falls inside the applied ranges. Targets are FIXED at generation time
    (the workload's hot key set sliced by the range) so the verifier knows
    the write set up front, while conflicts ride the RANGE domain."""

    def __init__(self, appends: Dict[object, int]):
        self.appends = appends

    def apply(self, key, store, execute_at: Timestamp) -> None:
        if key in self.appends:
            store.node.data_store.append(key, execute_at, self.appends[key])

    def apply_ranges(self, ranges: Ranges, store, execute_at: Timestamp) -> None:
        data_store: ListStore = store.node.data_store
        for k, v in self.appends.items():
            if ranges.contains_key(k):
                data_store.append(k, execute_at, v)


class ListRangeUpdate(api.Update):
    """Append `value` to each of `targets` (keys), with the conflict scope
    being `ranges` (range-domain deps/ordering)."""

    def __init__(self, ranges: Ranges, targets: Keys, value: int):
        self._ranges = ranges
        self._targets = targets
        self.value = value

    def keys(self) -> Ranges:
        return self._ranges

    def apply(self, execute_at: Timestamp, data) -> ListRangeWrite:
        return ListRangeWrite({k: self.value for k in self._targets})

    def slice(self, ranges: Ranges) -> "ListRangeUpdate":
        return ListRangeUpdate(self._ranges.intersection(ranges),
                               self._targets.slice(ranges), self.value)

    def merge(self, other: "ListRangeUpdate") -> "ListRangeUpdate":
        assert self.value == other.value
        return ListRangeUpdate(self._ranges.union(other._ranges),
                               self._targets.union(other._targets), self.value)

    def target_keys(self) -> Keys:
        return self._targets


class ListResult(api.Result):
    def __init__(self, txn_id: TxnId, execute_at: Timestamp,
                 reads: Dict[object, Tuple[int, ...]], write_value: Optional[int]):
        self.txn_id = txn_id
        self.execute_at = execute_at
        self.reads = reads
        self.write_value = write_value

    def __repr__(self):
        return f"ListResult({self.txn_id!r}, reads={self.reads!r}, w={self.write_value})"


class ListQuery(api.Query):
    def compute(self, txn_id: TxnId, execute_at: Timestamp, keys, data,
                read, update) -> ListResult:
        reads = dict(data.entries) if data is not None else {}
        # ensure every read KEY reports (possibly-empty) observations; a
        # range read's observations are whatever keys the scan found (a
        # Range itself is not a reads-dict key)
        if read is not None and isinstance(read.keys(), Keys):
            for k in read.keys():
                reads.setdefault(k, ())
        # a range WRITE's scan also observed each absent target key as empty:
        # report them so none of its per-key appends is a blind write (the
        # verifier tracks blind writes one key per value)
        target_keys = getattr(update, "target_keys", None)
        if target_keys is not None:
            for k in target_keys():
                reads.setdefault(k, ())
        return ListResult(txn_id, execute_at, reads,
                          update.value if update is not None else None)
