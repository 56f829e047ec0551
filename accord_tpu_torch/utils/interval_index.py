"""Interval stabbing/intersection index.

Role-equivalent to the reference's SearchableRangeList / CINTIA checkpoint
interval structure (utils/SearchableRangeList.java:22-60), which accelerates
RangeDeps and commandsForRanges queries. This is the classic augmented
sorted-array form of the same idea: entries sorted by start, plus a prefix
maximum of ends -- a stab or overlap query binary-searches the start bound
and walks left only while the prefix max proves an overlap can still exist
(the checkpoint role CINTIA's tree plays).

Mutations mark the index dirty; the sorted arrays rebuild lazily on the next
query (registrations arrive in bursts between queries, so rebuild-on-read
amortizes the way the reference's builder does).
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Dict, Iterator, List, Tuple


class IntervalIndex:
    __slots__ = ("_entries", "_starts", "_ends", "_values", "_prefix_max",
                 "_dirty")

    def __init__(self):
        self._entries: Dict[object, List[Tuple[int, int]]] = {}  # value -> intervals
        self._starts: List[int] = []
        self._ends: List[int] = []
        self._values: List[object] = []
        self._prefix_max: List[int] = []
        self._dirty = False

    def __len__(self) -> int:
        return len(self._entries)

    def add(self, value, start: int, end: int) -> None:
        self._entries.setdefault(value, []).append((start, end))
        self._dirty = True

    def remove(self, value) -> None:
        if self._entries.pop(value, None) is not None:
            self._dirty = True

    def _rebuild(self) -> None:
        rows = sorted((s, e, v) for v, ivs in self._entries.items()
                      for (s, e) in ivs)
        self._starts = [s for s, _, _ in rows]
        self._ends = [e for _, e, _ in rows]
        self._values = [v for _, _, v in rows]
        self._prefix_max = []
        m = 0
        for e in self._ends:
            m = e if e > m else m
            self._prefix_max.append(m)
        self._dirty = False

    def stab(self, key: int) -> Iterator:
        """Values whose ANY interval contains `key` (may yield duplicates for
        multi-interval values only if several of its intervals contain it)."""
        if self._dirty:
            self._rebuild()
        i = bisect_right(self._starts, key) - 1
        while i >= 0 and self._prefix_max[i] > key:
            if self._ends[i] > key:  # starts[i] <= key by construction
                yield self._values[i]
            i -= 1

    def over(self, start: int, end: int) -> Iterator:
        """Values with ANY interval intersecting [start, end)."""
        if self._dirty:
            self._rebuild()
        i = bisect_right(self._starts, end - 1) - 1
        while i >= 0 and self._prefix_max[i] > start:
            if self._ends[i] > start:
                yield self._values[i]
            i -= 1
