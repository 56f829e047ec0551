"""Dependency sets: the data the whole protocol revolves around.

Role-equivalent to the reference's KeyDeps/RangeDeps/Deps (primitives/
KeyDeps.java:51, RangeDeps.java:84, Deps.java:59): for each key (or range) a
transaction touches, the set of earlier conflicting TxnIds it must wait for.

Layout is CSR (compressed sparse row), same shape as the reference's
RelationMultiMap flat-array encoding -- keys[], unique txn_ids[], offsets[],
value_idx[] -- because CSR is simultaneously the mergeable host format and
the tensor-friendly format the TPU deps kernels produce/consume
(accord_tpu_torch.ops.deps_resolver converts CSR <-> padded dense batches).
"""
from __future__ import annotations

import array
from bisect import bisect_left
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

from accord_tpu_torch.primitives.keyspace import Key, Keys, Range, Ranges, Seekables
from accord_tpu_torch.primitives.timestamp import TxnId
from accord_tpu_torch.utils import sorted_arrays as sa

import operator

_ts_cmp = operator.attrgetter("_cmp")


def _rebuild_keydeps(keys, ids_blob: bytes, offsets_blob: bytes,
                     value_idx_blob: bytes) -> "KeyDeps":
    ids = array.array("q")
    ids.frombytes(ids_blob)
    it = iter(ids)
    txn_ids = tuple(TxnId._intern(e, h, f, n)
                    for e, h, f, n in zip(it, it, it, it))
    offsets = array.array("i")
    offsets.frombytes(offsets_blob)
    value_idx = array.array("i")
    value_idx.frombytes(value_idx_blob)
    return KeyDeps(keys, txn_ids, tuple(offsets), tuple(value_idx))


class KeyDeps:
    """key -> sorted set of TxnId, as CSR over sorted keys."""

    __slots__ = ("keys", "txn_ids", "offsets", "value_idx", "_packed",
                 "_by_txn")

    def __init__(self, keys: Tuple[Key, ...], txn_ids: Tuple[TxnId, ...],
                 offsets: Tuple[int, ...], value_idx: Tuple[int, ...]):
        self.keys = keys            # sorted unique keys
        self.txn_ids = txn_ids      # sorted unique txn ids (the dictionary)
        self.offsets = offsets      # len(keys)+1 row offsets into value_idx
        self.value_idx = value_idx  # indices into txn_ids, sorted per row
        self._packed = None         # cached wire blobs (see __reduce__)
        self._by_txn = None         # cached reverse index (participating_keys)

    def __reduce__(self):
        # deps sets dominate wire traffic: pack the id dictionary into one
        # int64 blob (4 lanes per id) and the CSR arrays into int32 blobs --
        # an order of magnitude fewer pickle ops than the object graph, and
        # decode interns the ids (see Timestamp.__reduce__). Cached: the same
        # deps object is pickled once per recipient of every broadcast.
        if self._packed is None:
            ids = array.array("q")
            for t in self.txn_ids:
                ids.append(t.epoch)
                ids.append(t.hlc)
                ids.append(t.flags)
                ids.append(t.node)
            self._packed = (self.keys, ids.tobytes(),
                            array.array("i", self.offsets).tobytes(),
                            array.array("i", self.value_idx).tobytes())
        return (_rebuild_keydeps, self._packed)

    # -- construction --------------------------------------------------------
    @classmethod
    def of(cls, mapping: Dict[Key, Iterable[TxnId]]) -> "KeyDeps":
        b = KeyDepsBuilder()
        for k, ids in mapping.items():
            for t in ids:
                b.add(k, t)
        return b.build()

    # -- queries -------------------------------------------------------------
    def is_empty(self) -> bool:
        return not self.keys

    def key_count(self) -> int:
        return len(self.keys)

    def txn_id_count(self) -> int:
        return len(self.txn_ids)

    def for_key(self, key: Key) -> Tuple[TxnId, ...]:
        i = bisect_left(self.keys, key)
        if i >= len(self.keys) or self.keys[i] != key:
            return ()
        lo, hi = self.offsets[i], self.offsets[i + 1]
        return tuple(self.txn_ids[v] for v in self.value_idx[lo:hi])

    def participating_keys(self, txn_id: TxnId) -> Keys:
        """Keys whose dep set includes txn_id (reference: participants()).
        Per-query memo: the progress engine asks this for the same blocked
        dep every sweep (a per-call row scan made sweeps quadratic under
        contention), but building a FULL reverse index per Deps instance is
        itself a top-5 cost when most instances are queried once."""
        memo = self._by_txn
        if memo is None:
            memo = self._by_txn = {}
        hit = memo.get(txn_id)
        if hit is not None:
            return hit
        i = sa.index_of(self.txn_ids, txn_id)
        if i < 0:
            out = Keys.EMPTY
        else:
            ks = []
            for row in range(len(self.keys)):
                lo, hi = self.offsets[row], self.offsets[row + 1]
                if sa.contains(self.value_idx[lo:hi], i):
                    ks.append(self.keys[row])
            out = Keys((), _sorted=tuple(ks))
        memo[txn_id] = out
        return out

    def all_txn_ids(self) -> Tuple[TxnId, ...]:
        return self.txn_ids

    def contains(self, txn_id: TxnId) -> bool:
        return sa.contains(self.txn_ids, txn_id)

    def max_txn_id(self) -> Optional[TxnId]:
        return self.txn_ids[-1] if self.txn_ids else None

    def items(self) -> Iterator[Tuple[Key, Tuple[TxnId, ...]]]:
        for i, k in enumerate(self.keys):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            yield k, tuple(self.txn_ids[v] for v in self.value_idx[lo:hi])

    # -- algebra -------------------------------------------------------------
    def union(self, other: "KeyDeps") -> "KeyDeps":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return KeyDeps(*_csr_union(
            self.keys, self.txn_ids, self.offsets, self.value_idx,
            other.keys, other.txn_ids, other.offsets, other.value_idx))

    def slice(self, ranges: Ranges) -> "KeyDeps":
        if self.is_empty() or ranges.is_empty():
            return KeyDeps.EMPTY
        b = KeyDepsBuilder()
        for k, ids in self.items():
            if ranges.contains_key(k):
                b.add_all(k, ids)
        return b.build()

    def without(self, pred: Callable[[TxnId], bool]) -> "KeyDeps":
        """Drop every txn_id for which pred is true."""
        b = KeyDepsBuilder()
        for k, ids in self.items():
            kept = [t for t in ids if not pred(t)]
            if kept:
                b.add_all(k, kept)
        return b.build()

    @staticmethod
    def merge(many: Sequence["KeyDeps"]) -> "KeyDeps":
        b = KeyDepsBuilder()
        for kd in many:
            for k, ids in kd.items():
                b.add_all(k, ids)
        return b.build()

    def __eq__(self, other):
        return (isinstance(other, KeyDeps) and self.keys == other.keys
                and self.txn_ids == other.txn_ids and self.offsets == other.offsets
                and self.value_idx == other.value_idx)

    def __hash__(self):
        return hash((self.keys, self.txn_ids))

    def __repr__(self):
        return "KeyDeps{" + ", ".join(f"{k}: {list(v)}" for k, v in self.items()) + "}"


class KeyDepsBuilder:
    __slots__ = ("_map",)

    def __init__(self):
        self._map: Dict[Key, set] = {}

    def add(self, key: Key, txn_id: TxnId) -> "KeyDepsBuilder":
        s = self._map.get(key)
        if s is None:
            self._map[key] = {txn_id}
        else:
            s.add(txn_id)
        return self

    def add_all(self, key: Key, txn_ids: Iterable[TxnId]) -> "KeyDepsBuilder":
        self._map.setdefault(key, set()).update(txn_ids)
        return self

    def build(self) -> KeyDeps:
        if not self._map:
            return KeyDeps.EMPTY
        keys = tuple(sorted(self._map))
        # key= sorts extract _cmp once per element instead of calling __lt__
        # per comparison -- deps builds are a top-5 simulator cost
        uniq = sorted(set().union(*self._map.values()), key=_ts_cmp)
        txn_ids = tuple(uniq)
        index = {t: i for i, t in enumerate(uniq)}
        offsets = [0]
        value_idx: List[int] = []
        for k in keys:
            row = sorted(index[t] for t in self._map[k])
            value_idx.extend(row)
            offsets.append(len(value_idx))
        return KeyDeps(keys, txn_ids, tuple(offsets), tuple(value_idx))


KeyDeps.EMPTY = KeyDeps((), (), (0,), ())


def _csr_union(a_keys, a_ids, a_off, a_vidx, b_keys, b_ids, b_off, b_vidx):
    """Linear union of two CSR multimaps (the reference's
    RelationMultiMap.linearUnion): single sorted sweeps, no per-element
    hashing. Works for KeyDeps and RangeDeps alike (rows sorted by key/range,
    ids sorted within the dictionary and within each row)."""
    # 1. merged dictionary + monotone index remaps for both sides
    ids: List = []
    remap_a = [0] * len(a_ids)
    remap_b = [0] * len(b_ids)
    i = j = 0
    while i < len(a_ids) or j < len(b_ids):
        if j >= len(b_ids) or (i < len(a_ids) and a_ids[i] <= b_ids[j]):
            if j < len(b_ids) and a_ids[i] == b_ids[j]:
                remap_b[j] = len(ids)
                j += 1
            remap_a[i] = len(ids)
            ids.append(a_ids[i])
            i += 1
        else:
            remap_b[j] = len(ids)
            ids.append(b_ids[j])
            j += 1
    # 2. merge rows in key order; remapped rows stay sorted (remaps monotone)
    keys: List = []
    offsets = [0]
    value_idx: List[int] = []
    i = j = 0
    while i < len(a_keys) or j < len(b_keys):
        if j >= len(b_keys) or (i < len(a_keys) and a_keys[i] < b_keys[j]):
            keys.append(a_keys[i])
            value_idx.extend(remap_a[v] for v in a_vidx[a_off[i]:a_off[i + 1]])
            i += 1
        elif i >= len(a_keys) or b_keys[j] < a_keys[i]:
            keys.append(b_keys[j])
            value_idx.extend(remap_b[v] for v in b_vidx[b_off[j]:b_off[j + 1]])
            j += 1
        else:  # same key: sorted-merge the two rows, deduplicating
            keys.append(a_keys[i])
            ra = [remap_a[v] for v in a_vidx[a_off[i]:a_off[i + 1]]]
            rb = [remap_b[v] for v in b_vidx[b_off[j]:b_off[j + 1]]]
            p = q = 0
            while p < len(ra) or q < len(rb):
                if q >= len(rb) or (p < len(ra) and ra[p] <= rb[q]):
                    if q < len(rb) and ra[p] == rb[q]:
                        q += 1
                    value_idx.append(ra[p])
                    p += 1
                else:
                    value_idx.append(rb[q])
                    q += 1
            i += 1
            j += 1
        offsets.append(len(value_idx))
    return tuple(keys), tuple(ids), tuple(offsets), tuple(value_idx)


class RangeDeps:
    """range -> sorted set of TxnId. Linear-scan interval queries for now; the
    reference accelerates this with a checkpointed interval index
    (SearchableRangeList, utils/SearchableRangeList.java) and the TPU path
    will use interval bitmaps -- both are internal representations behind the
    same query surface."""

    __slots__ = ("ranges", "txn_ids", "offsets", "value_idx", "_by_txn")

    def __init__(self, ranges: Tuple[Range, ...], txn_ids: Tuple[TxnId, ...],
                 offsets: Tuple[int, ...], value_idx: Tuple[int, ...]):
        self.ranges = ranges
        self.txn_ids = txn_ids
        self.offsets = offsets
        self.value_idx = value_idx
        self._by_txn = None   # cached reverse index (participating_ranges)

    def __reduce__(self):
        # skip the cache slot on the wire
        return (RangeDeps,
                (self.ranges, self.txn_ids, self.offsets, self.value_idx))

    def participating_ranges(self, txn_id: TxnId) -> Tuple[Range, ...]:
        """Ranges whose dep set includes txn_id (per-query memo, same
        rationale as KeyDeps.participating_keys)."""
        memo = self._by_txn
        if memo is None:
            memo = self._by_txn = {}
        hit = memo.get(txn_id)
        if hit is not None:
            return hit
        i = sa.index_of(self.txn_ids, txn_id)
        out: Tuple[Range, ...] = ()
        if i >= 0:
            out = tuple(
                self.ranges[row] for row in range(len(self.ranges))
                if sa.contains(
                    self.value_idx[self.offsets[row]:self.offsets[row + 1]], i))
        memo[txn_id] = out
        return out

    @classmethod
    def of(cls, mapping: Dict[Range, Iterable[TxnId]]) -> "RangeDeps":
        b = RangeDepsBuilder()
        for r, ids in mapping.items():
            b.add_all(r, ids)
        return b.build()

    def is_empty(self) -> bool:
        return not self.ranges

    def items(self) -> Iterator[Tuple[Range, Tuple[TxnId, ...]]]:
        for i, r in enumerate(self.ranges):
            lo, hi = self.offsets[i], self.offsets[i + 1]
            yield r, tuple(self.txn_ids[v] for v in self.value_idx[lo:hi])

    def for_key(self, key: Key) -> Tuple[TxnId, ...]:
        out: set = set()
        for r, ids in self.items():
            if r.contains(key):
                out.update(ids)
        return tuple(sorted(out))

    def intersecting(self, target: Range) -> Tuple[TxnId, ...]:
        out: set = set()
        for r, ids in self.items():
            if r.intersects(target):
                out.update(ids)
        return tuple(sorted(out))

    def all_txn_ids(self) -> Tuple[TxnId, ...]:
        return self.txn_ids

    def contains(self, txn_id: TxnId) -> bool:
        return sa.contains(self.txn_ids, txn_id)

    def max_txn_id(self) -> Optional[TxnId]:
        return self.txn_ids[-1] if self.txn_ids else None

    def union(self, other: "RangeDeps") -> "RangeDeps":
        if self.is_empty():
            return other
        if other.is_empty():
            return self
        return RangeDeps(*_csr_union(
            self.ranges, self.txn_ids, self.offsets, self.value_idx,
            other.ranges, other.txn_ids, other.offsets, other.value_idx))

    def slice(self, window: Ranges) -> "RangeDeps":
        if self.is_empty() or window.is_empty():
            return RangeDeps.EMPTY
        b = RangeDepsBuilder()
        for r, ids in self.items():
            for w in window:
                x = r.intersection(w)
                if x is not None:
                    b.add_all(x, ids)
        return b.build()

    def without(self, pred: Callable[[TxnId], bool]) -> "RangeDeps":
        b = RangeDepsBuilder()
        for r, ids in self.items():
            kept = [t for t in ids if not pred(t)]
            if kept:
                b.add_all(r, kept)
        return b.build()

    @staticmethod
    def merge(many: Sequence["RangeDeps"]) -> "RangeDeps":
        b = RangeDepsBuilder()
        for rd in many:
            for r, ids in rd.items():
                b.add_all(r, ids)
        return b.build()

    def __eq__(self, other):
        return (isinstance(other, RangeDeps) and self.ranges == other.ranges
                and self.txn_ids == other.txn_ids and self.offsets == other.offsets
                and self.value_idx == other.value_idx)

    def __hash__(self):
        return hash((self.ranges, self.txn_ids))

    def __repr__(self):
        return "RangeDeps{" + ", ".join(f"{r}: {list(v)}" for r, v in self.items()) + "}"


class RangeDepsBuilder:
    __slots__ = ("_map",)

    def __init__(self):
        self._map: Dict[Range, set] = {}

    def add(self, rng: Range, txn_id: TxnId) -> "RangeDepsBuilder":
        self._map.setdefault(rng, set()).add(txn_id)
        return self

    def add_all(self, rng: Range, txn_ids: Iterable[TxnId]) -> "RangeDepsBuilder":
        self._map.setdefault(rng, set()).update(txn_ids)
        return self

    def build(self) -> RangeDeps:
        if not self._map:
            return RangeDeps.EMPTY
        ranges = tuple(sorted(self._map))
        uniq = sorted(set().union(*self._map.values()))
        txn_ids = tuple(uniq)
        index = {t: i for i, t in enumerate(uniq)}
        offsets = [0]
        value_idx: List[int] = []
        for r in ranges:
            row = sorted(index[t] for t in self._map[r])
            value_idx.extend(row)
            offsets.append(len(value_idx))
        return RangeDeps(ranges, txn_ids, tuple(offsets), tuple(value_idx))


RangeDeps.EMPTY = RangeDeps((), (), (0,), ())


class Deps:
    """KeyDeps + RangeDeps pair (reference: primitives/Deps.java:59; we fold
    the reference's third `directKeyDeps` component into key_deps -- it exists
    there only to optimize range-txn handling below a boundary)."""

    __slots__ = ("key_deps", "range_deps")

    def __init__(self, key_deps: KeyDeps = KeyDeps.EMPTY,
                 range_deps: RangeDeps = RangeDeps.EMPTY):
        self.key_deps = key_deps
        self.range_deps = range_deps

    def is_empty(self) -> bool:
        return self.key_deps.is_empty() and self.range_deps.is_empty()

    def for_key(self, key: Key) -> Tuple[TxnId, ...]:
        return tuple(sorted(set(self.key_deps.for_key(key)) | set(self.range_deps.for_key(key))))

    def all_txn_ids(self) -> Tuple[TxnId, ...]:
        return sa.linear_union(self.key_deps.all_txn_ids(), self.range_deps.all_txn_ids())

    def contains(self, txn_id: TxnId) -> bool:
        return self.key_deps.contains(txn_id) or self.range_deps.contains(txn_id)

    def max_txn_id(self) -> Optional[TxnId]:
        from accord_tpu_torch.primitives.timestamp import Timestamp
        return Timestamp.merge_max(self.key_deps.max_txn_id(), self.range_deps.max_txn_id())

    def contains_for(self, key: Key, txn_id: TxnId) -> bool:
        """Is txn_id a dependency under this specific key? (the per-key
        witness test recovery relies on -- reference TestDep WITH/WITHOUT)"""
        return txn_id in self.key_deps.for_key(key) \
            or txn_id in self.range_deps.for_key(key)

    def participants_of(self, txn_id: TxnId):
        """Keys (or, for range-deps rows, Ranges) under which txn_id appears
        (reference: Deps.participants) -- where a probe/recovery for it must
        be addressed. A sync point's deps live in range rows, so consulting
        only key rows would leave its blocked deps unprobeable."""
        keys = self.key_deps.participating_keys(txn_id)
        if not keys.is_empty():
            return keys
        rngs = self.range_deps.participating_ranges(txn_id)
        return Ranges(rngs) if rngs else None

    def union(self, other: "Deps") -> "Deps":
        return Deps(self.key_deps.union(other.key_deps),
                    self.range_deps.union(other.range_deps))

    def slice(self, ranges: Ranges) -> "Deps":
        return Deps(self.key_deps.slice(ranges), self.range_deps.slice(ranges))

    def without(self, pred: Callable[[TxnId], bool]) -> "Deps":
        return Deps(self.key_deps.without(pred), self.range_deps.without(pred))

    @staticmethod
    def merge(many: Sequence["Deps"]) -> "Deps":
        return Deps(KeyDeps.merge([d.key_deps for d in many]),
                    RangeDeps.merge([d.range_deps for d in many]))

    def __eq__(self, other):
        return (isinstance(other, Deps) and self.key_deps == other.key_deps
                and self.range_deps == other.range_deps)

    def __hash__(self):
        return hash((self.key_deps, self.range_deps))

    def __repr__(self):
        return f"Deps({self.key_deps!r}, {self.range_deps!r})"


Deps.NONE = Deps()
