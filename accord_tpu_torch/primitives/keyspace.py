"""Key and range collections with sorted-set algebra.

Role-equivalent to the reference's Routables hierarchy (primitives/
Routables.java:35, Keys, Ranges, AbstractKeys/AbstractRanges): flat sorted
collections with linear-merge union/intersection/slice. We deliberately keep a
much smaller surface: a Key is any totally-ordered hashable value (the host
SPI decides what that is -- the burn test uses ints over a hash domain, which
is also the natural index for the TPU interval-bitmap encoding); a Range is
half-open [start, end); Keys/Ranges are sorted unique tuples.

`Seekables` in the reference = Keys | Ranges here; code that accepts either
uses the shared `domain` property to dispatch.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from typing import Any, Iterable, Iterator, Optional, Sequence, Tuple, Union

from accord_tpu_torch.primitives.timestamp import Domain
from accord_tpu_torch.utils import sorted_arrays as sa

# A Key is any totally ordered, hashable value (api.Key SPI narrows this).
Key = Any


class Keys:
    """Immutable sorted unique set of keys."""

    __slots__ = ("_keys",)
    domain = Domain.KEY

    def __init__(self, keys: Iterable[Key] = (), *, _sorted: Optional[Tuple[Key, ...]] = None):
        if _sorted is not None:
            self._keys = _sorted
        else:
            self._keys = tuple(sorted(set(keys)))

    @classmethod
    def of(cls, *keys: Key) -> "Keys":
        return cls(keys)

    @classmethod
    def _wrap(cls, sorted_keys: Tuple[Key, ...]) -> "Keys":
        return cls(_sorted=sorted_keys)

    def __iter__(self) -> Iterator[Key]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __getitem__(self, i: int) -> Key:
        return self._keys[i]

    def __contains__(self, key: Key) -> bool:
        return sa.contains(self._keys, key)

    def __eq__(self, other):
        return isinstance(other, Keys) and self._keys == other._keys

    def __hash__(self):
        return hash(self._keys)

    def __repr__(self):
        return f"Keys{list(self._keys)!r}"

    def is_empty(self) -> bool:
        return not self._keys

    def as_tuple(self) -> Tuple[Key, ...]:
        return self._keys

    def union(self, other: "Keys") -> "Keys":
        return Keys._wrap(sa.linear_union(self._keys, other._keys))

    def intersection(self, other: "Keys") -> "Keys":
        return Keys._wrap(sa.linear_intersection(self._keys, other._keys))

    def difference(self, other: "Keys") -> "Keys":
        return Keys._wrap(sa.linear_difference(self._keys, other._keys))

    def with_key(self, key: Key) -> "Keys":
        return Keys._wrap(sa.insert(self._keys, key))

    def slice(self, ranges: "Ranges") -> "Keys":
        """Keys covered by any of the given ranges."""
        if ranges.is_empty() or self.is_empty():
            return Keys.EMPTY
        out = []
        for r in ranges:
            lo = bisect_left(self._keys, r.start)
            hi = bisect_left(self._keys, r.end)
            out.extend(self._keys[lo:hi])
        return Keys._wrap(tuple(out))

    def intersects_ranges(self, ranges: "Ranges") -> bool:
        return any(True for r in ranges
                   if bisect_left(self._keys, r.start) < bisect_left(self._keys, r.end))

    def intersects(self, other: Union["Keys", "Ranges"]) -> bool:
        if isinstance(other, Ranges):
            return self.intersects_ranges(other)
        return bool(sa.next_intersection(self._keys, 0, other._keys, 0))

    def to_ranges(self) -> "Ranges":
        """Minimal point ranges covering these keys (for uniform treatment of
        key txns by range machinery)."""
        return Ranges(Range.point(k) for k in self._keys)


Keys.EMPTY = Keys(())


class Range:
    """Half-open key interval [start, end). Ordered by (start, end)."""

    __slots__ = ("start", "end")

    def __init__(self, start: Key, end: Key):
        assert start < end, f"empty/inverted range [{start},{end})"
        object.__setattr__(self, "start", start)
        object.__setattr__(self, "end", end)

    def __setattr__(self, *a):
        raise AttributeError("immutable")

    def __reduce__(self):
        return (Range, (self.start, self.end))

    @classmethod
    def point(cls, key: Key) -> "Range":
        return cls(key, _Successor(key))

    def _key(self):
        return (self.start, self.end)

    def __lt__(self, other: "Range"):
        return self._key() < other._key()

    def __le__(self, other: "Range"):
        return self._key() <= other._key()

    def __eq__(self, other):
        return isinstance(other, Range) and self._key() == other._key()

    def __hash__(self):
        return hash((Range, self.start, self.end))

    def __repr__(self):
        return f"[{self.start},{self.end})"

    def contains(self, key: Key) -> bool:
        return self.start <= key < self.end

    def contains_range(self, other: "Range") -> bool:
        return self.start <= other.start and other.end <= self.end

    def intersects(self, other: "Range") -> bool:
        return self.start < other.end and other.start < self.end

    def intersection(self, other: "Range") -> Optional["Range"]:
        s = max(self.start, other.start)
        e = min(self.end, other.end)
        return Range(s, e) if s < e else None


class _Successor:
    """end bound for a point range: the smallest value greater than `key`
    under the host ordering. Compares just above its wrapped key."""

    __slots__ = ("key",)

    def __init__(self, key):
        self.key = key

    def _cmp_key(self, other):
        # returns -1/0/1 of self vs other
        ok = other.key if isinstance(other, _Successor) else other
        obump = 1 if isinstance(other, _Successor) else 0
        if self.key < ok:
            return -1
        if ok < self.key:
            return 1
        return 1 - obump  # equal keys: successor sorts after plain

    def __lt__(self, other):
        return self._cmp_key(other) < 0

    def __le__(self, other):
        return self._cmp_key(other) <= 0

    def __gt__(self, other):
        return self._cmp_key(other) > 0

    def __ge__(self, other):
        return self._cmp_key(other) >= 0

    def __eq__(self, other):
        return isinstance(other, _Successor) and not (self.key < other.key or other.key < self.key)

    def __hash__(self):
        return hash(("succ", self.key))

    def __repr__(self):
        return f"{self.key}+"


class Ranges:
    """Immutable sorted set of ranges. Construction normalizes: sorts and
    merges overlapping/adjacent-equal ranges so the invariant is
    'sorted by start, non-overlapping'."""

    __slots__ = ("_ranges", "_starts")
    domain = Domain.RANGE

    def __init__(self, ranges: Iterable[Range] = (), *, _normalized: Optional[Tuple[Range, ...]] = None):
        if _normalized is not None:
            self._ranges = _normalized
        else:
            self._ranges = _normalize(list(ranges))
        self._starts = tuple(r.start for r in self._ranges)

    @classmethod
    def of(cls, *ranges: Range) -> "Ranges":
        return cls(ranges)

    @classmethod
    def single(cls, start: Key, end: Key) -> "Ranges":
        return cls((Range(start, end),))

    def __iter__(self) -> Iterator[Range]:
        return iter(self._ranges)

    def __len__(self) -> int:
        return len(self._ranges)

    def to_ranges(self) -> "Ranges":
        """Uniform Seekables surface (Keys.to_ranges converts; Ranges is
        already ranges)."""
        return self

    def __getitem__(self, i: int) -> Range:
        return self._ranges[i]

    def __eq__(self, other):
        return isinstance(other, Ranges) and self._ranges == other._ranges

    def __hash__(self):
        return hash(self._ranges)

    def __repr__(self):
        return f"Ranges{list(self._ranges)!r}"

    def is_empty(self) -> bool:
        return not self._ranges

    def contains_key(self, key: Key) -> bool:
        i = bisect_right(self._starts, key) - 1
        return i >= 0 and self._ranges[i].contains(key)

    def contains_ranges(self, other: "Ranges") -> bool:
        return all(any(r.contains_range(o) for r in self._ranges) for o in other)

    def intersects(self, other: Union["Ranges", Keys]) -> bool:
        if isinstance(other, Keys):
            return other.intersects_ranges(self)
        i = j = 0
        while i < len(self._ranges) and j < len(other._ranges):
            a, b = self._ranges[i], other._ranges[j]
            if a.intersects(b):
                return True
            if a.end <= b.start:
                i += 1
            else:
                j += 1
        return False

    def union(self, other: "Ranges") -> "Ranges":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return Ranges(tuple(self._ranges) + tuple(other._ranges))

    def intersection(self, other: "Ranges") -> "Ranges":
        out = []
        i = j = 0
        while i < len(self._ranges) and j < len(other._ranges):
            a, b = self._ranges[i], other._ranges[j]
            x = a.intersection(b)
            if x is not None:
                out.append(x)
            if a.end <= b.end:
                i += 1
            else:
                j += 1
        return Ranges(_normalized=tuple(out))

    def difference(self, other: "Ranges") -> "Ranges":
        """Portions of self not covered by other."""
        out = []
        for r in self._ranges:
            pieces = [r]
            for o in other:
                nxt = []
                for p in pieces:
                    if not p.intersects(o):
                        nxt.append(p)
                        continue
                    if p.start < o.start:
                        nxt.append(Range(p.start, o.start))
                    if o.end < p.end:
                        nxt.append(Range(o.end, p.end))
                pieces = nxt
                if not pieces:
                    break
            out.extend(pieces)
        return Ranges(_normalized=tuple(out))

    def slice(self, window: "Ranges") -> "Ranges":
        return self.intersection(window)


def _normalize(ranges: list) -> Tuple[Range, ...]:
    if not ranges:
        return ()
    ranges.sort()
    out = [ranges[0]]
    for r in ranges[1:]:
        last = out[-1]
        if r.start <= last.end:  # overlap or adjacency at identical bound
            if r.end > last.end:
                out[-1] = Range(last.start, r.end)
        else:
            out.append(r)
    return tuple(out)


Ranges.EMPTY = Ranges(())

# "Seekables": anything data-addressable -- keys or ranges.
Seekables = Union[Keys, Ranges]
