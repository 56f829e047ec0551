"""Sorted-sequence set algebra.

Role-equivalent to the reference's SortedArrays (utils/SortedArrays.java):
linear-merge union/intersection/difference over sorted unique tuples, plus
exponential search. These back the Keys/Ranges/Deps value types. Tuples (not
lists) so primitive collections are hashable and safely shareable; the CSR/
flat-array layout is also exactly what the TPU data plane consumes.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Callable, Sequence, Tuple, TypeVar

T = TypeVar("T")


def linear_union(a: Sequence[T], b: Sequence[T]) -> Tuple[T, ...]:
    """Union of two sorted unique sequences. Returns a sorted unique tuple.
    Fast-paths return the identical input object when one contains the other."""
    if not a:
        return tuple(b)
    if not b:
        return tuple(a)
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    only_a = only_b = True
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            out.append(x)
            i += 1
            only_b = False
        elif y < x:
            out.append(y)
            j += 1
            only_a = False
        else:
            out.append(x)
            i += 1
            j += 1
    if i < na:
        out.extend(a[i:])
        only_b = False
    if j < nb:
        out.extend(b[j:])
        only_a = False
    if only_a and len(out) == na:
        return tuple(a)
    if only_b and len(out) == nb:
        return tuple(b)
    return tuple(out)


def linear_intersection(a: Sequence[T], b: Sequence[T]) -> Tuple[T, ...]:
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            i += 1
        elif y < x:
            j += 1
        else:
            out.append(x)
            i += 1
            j += 1
    return tuple(out)


def linear_difference(a: Sequence[T], b: Sequence[T]) -> Tuple[T, ...]:
    """Elements of sorted-unique a not in sorted-unique b."""
    out = []
    i = j = 0
    na, nb = len(a), len(b)
    while i < na and j < nb:
        x, y = a[i], b[j]
        if x < y:
            out.append(x)
            i += 1
        elif y < x:
            j += 1
        else:
            i += 1
            j += 1
    out.extend(a[i:])
    return tuple(out)


def contains(a: Sequence[T], item: T) -> bool:
    i = bisect_left(a, item)
    return i < len(a) and a[i] == item


def index_of(a: Sequence[T], item: T) -> int:
    """Index of item in sorted a, or -(insertion_point)-1 if absent (mirrors
    Java's binarySearch contract, which the reference leans on heavily)."""
    i = bisect_left(a, item)
    if i < len(a) and a[i] == item:
        return i
    return -(i + 1)


def insert(a: Sequence[T], item: T) -> Tuple[T, ...]:
    """Insert into sorted unique sequence; returns input unchanged if present."""
    i = bisect_left(a, item)
    if i < len(a) and a[i] == item:
        return tuple(a)
    return tuple(a[:i]) + (item,) + tuple(a[i:])


def remove(a: Sequence[T], item: T) -> Tuple[T, ...]:
    i = bisect_left(a, item)
    if i < len(a) and a[i] == item:
        return tuple(a[:i]) + tuple(a[i + 1:])
    return tuple(a)


def is_sorted_unique(a: Sequence[T]) -> bool:
    return all(a[i] < a[i + 1] for i in range(len(a) - 1))


def next_intersection(a: Sequence[T], ai: int, b: Sequence[T], bi: int):
    """Find the next (i, j) with a[i] == b[j], i >= ai, j >= bi; None if none.
    Galloping variant of the reference's findNextIntersection."""
    na, nb = len(a), len(b)
    while ai < na and bi < nb:
        x, y = a[ai], b[bi]
        if x == y:
            return ai, bi
        if x < y:
            ai = bisect_left(a, y, ai + 1)
        else:
            bi = bisect_left(b, x, bi + 1)
    return None


__all__ = [
    "linear_union", "linear_intersection", "linear_difference", "contains",
    "index_of", "insert", "remove", "is_sorted_unique", "next_intersection",
    "bisect_left", "bisect_right",
]
