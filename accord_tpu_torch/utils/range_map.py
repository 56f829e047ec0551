"""Immutable range->value maps with merge(reduce) semantics.

Role-equivalent to the reference's ReducingIntervalMap/ReducingRangeMap
(utils/ReducingRangeMap.java), which underlie RedundantBefore, DurableBefore,
MaxConflicts and LatestDeps. Representation: sorted boundary keys b0<..<bn and
values v0..v(n-1), where values[i] covers the half-open interval
[bounds[i], bounds[i+1]). Keys outside all intervals map to None.
"""
from __future__ import annotations

from bisect import bisect_right
from typing import Any, Callable, Generic, Iterable, List, Optional, Tuple, TypeVar

V = TypeVar("V")


class ReducingRangeMap(Generic[V]):
    __slots__ = ("bounds", "values")

    EMPTY: "ReducingRangeMap"

    def __init__(self, bounds: Tuple[Any, ...] = (), values: Tuple[Optional[V], ...] = ()):
        assert len(bounds) == 0 or len(values) == len(bounds) - 1
        assert all(bounds[i] < bounds[i + 1] for i in range(len(bounds) - 1))
        self.bounds = bounds
        self.values = values

    def is_empty(self) -> bool:
        return not self.bounds

    def get(self, key) -> Optional[V]:
        """Value covering key, or None."""
        if not self.bounds:
            return None
        i = bisect_right(self.bounds, key) - 1
        if i < 0 or i >= len(self.values):
            return None
        return self.values[i]

    def fold_over_range(self, start, end, fn: Callable[[Optional[V], Any], Any], acc):
        """fold fn(acc, value) over every value segment intersecting [start, end)."""
        if not self.bounds or start >= end:
            return acc
        i = max(0, bisect_right(self.bounds, start) - 1)
        while i < len(self.values):
            seg_start = self.bounds[i]
            seg_end = self.bounds[i + 1]
            if seg_start >= end:
                break
            if seg_end > start and self.values[i] is not None:
                acc = fn(acc, self.values[i])
            i += 1
        return acc

    def covers(self, start, end, pred: Callable[[V], bool]) -> bool:
        """True when every point of [start, end) lies in a segment whose
        non-None value satisfies pred (gaps fail)."""
        if start >= end:
            return True
        if not self.bounds:
            return False
        i = bisect_right(self.bounds, start) - 1
        if i < 0:
            return False
        pos = start
        while pos < end:
            if i >= len(self.values):
                return False
            seg_start, seg_end, v = self.bounds[i], self.bounds[i + 1], self.values[i]
            if seg_start > pos or v is None or not pred(v):
                return False
            pos = seg_end
            i += 1
        return True

    def segments_where(self, start, end, pred: Callable[[V], bool]):
        """Yield (seg_start, seg_end) clipped to [start, end) for every
        segment whose non-None value satisfies pred."""
        if not self.bounds or start >= end:
            return
        i = max(0, bisect_right(self.bounds, start) - 1)
        while i < len(self.values):
            seg_start, seg_end, v = self.bounds[i], self.bounds[i + 1], self.values[i]
            if seg_start >= end:
                break
            if seg_end > start and v is not None and pred(v):
                yield max(seg_start, start), min(seg_end, end)
            i += 1

    def fold_values(self, fn: Callable[[Any, V], Any], acc):
        for v in self.values:
            if v is not None:
                acc = fn(acc, v)
        return acc

    def segments(self) -> Iterable[Tuple[Any, Any, Optional[V]]]:
        for i, v in enumerate(self.values):
            yield self.bounds[i], self.bounds[i + 1], v

    def with_range(self, start, end, value: V, reduce: Callable[[V, V], V]) -> "ReducingRangeMap[V]":
        """Merge `value` into [start, end): existing segments inside the window
        get reduce(old, value); uncovered gaps get `value`."""
        if start >= end:
            return self
        return merge(self, ReducingRangeMap((start, end), (value,)), reduce)

    def __eq__(self, other):
        return (
            isinstance(other, ReducingRangeMap)
            and self.bounds == other.bounds
            and self.values == other.values
        )

    def __hash__(self):
        return hash((self.bounds, self.values))

    def __repr__(self):
        segs = ", ".join(f"[{s},{e}):{v!r}" for s, e, v in self.segments())
        return f"RangeMap({segs})"


ReducingRangeMap.EMPTY = ReducingRangeMap()


def merge(a: ReducingRangeMap, b: ReducingRangeMap, reduce: Callable) -> ReducingRangeMap:
    """Merge two maps; overlapping segments combine with reduce(av, bv)."""
    if a.is_empty():
        return b
    if b.is_empty():
        return a
    # Sweep over the union of boundary points.
    points: List[Any] = sorted(set(a.bounds) | set(b.bounds))
    bounds: List[Any] = []
    values: List[Any] = []
    for i in range(len(points) - 1):
        lo = points[i]
        av = a.get(lo)
        bv = b.get(lo)
        if av is None:
            v = bv
        elif bv is None:
            v = av
        else:
            v = reduce(av, bv)
        bounds.append(lo)
        values.append(v)
    bounds.append(points[-1])
    # Normalize: drop leading/trailing None segments, merge equal neighbours.
    return _normalize(bounds, values)


def min_intersection(a: ReducingRangeMap, b: ReducingRangeMap) -> ReducingRangeMap:
    """Pointwise min where BOTH maps have a value; absent anywhere either is
    absent (unlike merge(), which fills gaps from the other map). Used for
    truncation floors: state may only be truncated where it is both locally
    redundant AND durable."""
    if a.is_empty() or b.is_empty():
        return ReducingRangeMap.EMPTY
    points: List[Any] = sorted(set(a.bounds) | set(b.bounds))
    bounds: List[Any] = []
    values: List[Any] = []
    for i in range(len(points) - 1):
        lo = points[i]
        av, bv = a.get(lo), b.get(lo)
        v = min(av, bv) if av is not None and bv is not None else None
        bounds.append(lo)
        values.append(v)
    bounds.append(points[-1])
    return _normalize(bounds, values)


def _normalize(bounds: List[Any], values: List[Any]) -> ReducingRangeMap:
    """Drop leading/trailing None segments and merge equal neighbours."""
    nb: List[Any] = []
    nv: List[Any] = []
    for i, v in enumerate(values):
        if not nv and v is None:
            continue  # leading None
        if nv and nv[-1] == v:
            continue  # extend previous segment; skip boundary
        nb.append(bounds[i])
        nv.append(v)
    if not nv:
        return ReducingRangeMap.EMPTY
    last_non_none = max(i for i, v in enumerate(values) if v is not None)
    nb.append(bounds[last_non_none + 1])
    while nv and nv[-1] is None:
        nv.pop()
        nb.pop(-2)
    return ReducingRangeMap(tuple(nb), tuple(nv))
