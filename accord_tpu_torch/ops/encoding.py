"""Host<->device encoding for protocol values.

Timestamps: the protocol orders by (epoch, hlc, flags, node). TPUs prefer
int32 lanes (int64 is emulated), so the device encoding is three int32 lanes
relative to a per-batch base, compared lexicographically:

  lane0 = epoch - base_epoch          (small non-negative int)
  lane1 = hlc - base_hlc              (window-checked: |delta| < 2^31 us)
  lane2 = flags << 16 | node

The hlc window (~35 minutes of microseconds) vastly exceeds any active-set
span; the encoder verifies membership and the resolver asserts rather than
silently dropping out-of-window entries.

Keys: the burn test's hash-key domain maps keys directly to bitmap columns
via key % K buckets. Bucketing makes the bitmap a *conservative overestimate*
(two keys may share a column), which is safe for deps (extra deps are merely
redundant edges, and the host CSR conversion re-filters per real key).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TxnKind

# WITNESS_TABLE[a, b] == 1 iff kind a witnesses kind b (mirrors
# primitives.timestamp._WITNESSES, itself a mirror of reference
# Txn.Kind.witnesses primitives/Txn.java:224).
WITNESS_TABLE = np.zeros((6, 6), dtype=np.int32)
for _a in TxnKind:
    for _b in TxnKind:
        WITNESS_TABLE[int(_a), int(_b)] = 1 if _a.witnesses(_b) else 0

_WINDOW = (1 << 31) - 1


class TimestampEncoder:
    """Encodes a batch of timestamps as int32 (lane0, lane1) pairs with a
    shared (epoch, hlc) base."""

    def __init__(self, base_epoch: int, base_hlc: int):
        self.base_epoch = base_epoch
        self.base_hlc = base_hlc

    @classmethod
    def for_timestamps(cls, tss: Sequence[Timestamp]) -> "TimestampEncoder":
        if not tss:
            return cls(0, 0)
        lo = min(tss)
        return cls(lo.epoch, lo.hlc)

    def in_window(self, ts: Timestamp) -> bool:
        return (0 <= ts.epoch - self.base_epoch < _WINDOW
                and -_WINDOW < ts.hlc - self.base_hlc < _WINDOW)

    def encode(self, tss: Sequence[Timestamp]) -> np.ndarray:
        """-> int32[len(tss), 3]; raises if any timestamp out of window."""
        out = np.empty((len(tss), 3), dtype=np.int32)
        for i, ts in enumerate(tss):
            if not self.in_window(ts):
                raise ValueError(f"timestamp {ts} outside encoder window")
            out[i, 0] = ts.epoch - self.base_epoch
            out[i, 1] = ts.hlc - self.base_hlc
            # biased so the full 32-bit (flags, node) space -- including the
            # REJECTED flag in bit 15 of flags -- fits a SIGNED int32 lane
            # while preserving order
            out[i, 2] = ((ts.flags << 16) | ts.node) - (1 << 31)
        return out

    def encode_one(self, ts: Timestamp) -> Tuple[int, int, int]:
        """Single-timestamp fast path (no array round trip): the arena's
        per-registration lane updates assign the 3 lanes directly."""
        if not self.in_window(ts):
            raise ValueError(f"timestamp {ts} outside encoder window")
        return (ts.epoch - self.base_epoch, ts.hlc - self.base_hlc,
                ((ts.flags << 16) | ts.node) - (1 << 31))

    def encode_many(self, tss: Sequence[Timestamp]) -> np.ndarray:
        """Bulk twin of encode(): attribute gathers via np.fromiter and a
        vectorized window check instead of a per-timestamp Python loop --
        the dispatch encode at large batch sizes is bounded by this."""
        n = len(tss)
        out = np.empty((n, 3), dtype=np.int64)
        out[:, 0] = np.fromiter((t.epoch for t in tss), np.int64, n)
        out[:, 0] -= self.base_epoch
        out[:, 1] = np.fromiter((t.hlc for t in tss), np.int64, n)
        out[:, 1] -= self.base_hlc
        out[:, 2] = np.fromiter(((t.flags << 16) | t.node for t in tss),
                                np.int64, n)
        out[:, 2] -= 1 << 31
        if n and not (
                (out[:, 0] >= 0).all() and (out[:, 0] < _WINDOW).all()
                and (np.abs(out[:, 1]) < _WINDOW).all()):
            for t in tss:
                if not self.in_window(t):
                    raise ValueError(f"timestamp {t} outside encoder window")
        return out.astype(np.int32)


def encode_key_bitmaps(key_sets: Sequence[Sequence[int]], num_buckets: int) -> np.ndarray:
    """-> float bitmap [len(key_sets), num_buckets] with 1.0 where the txn
    touches a key hashing to that bucket (float for MXU matmul). Vectorized
    NumPy scatter -- one fancy-index assignment, no per-key Python loop."""
    n = len(key_sets)
    out = np.zeros((n, num_buckets), dtype=np.float32)
    counts = np.fromiter((len(ks) for ks in key_sets), dtype=np.int64, count=n)
    total = int(counts.sum())
    if total == 0:
        return out
    rows = np.repeat(np.arange(n), counts)
    cols = np.fromiter((int(k) for ks in key_sets for k in ks),
                       dtype=np.int64, count=total) % num_buckets
    out[rows, cols] = 1.0
    return out


def encode_kinds(txn_ids: Sequence[TxnId]) -> np.ndarray:
    return np.array([int(t.kind) for t in txn_ids], dtype=np.int32)


# Half-open [start, end) intervals as int32 pairs for the range arena /
# range-subject CSR. A _Successor endpoint (Range.point(k) ends "just above
# k") encodes as k+1 -- exact for integer keys, where nothing orders strictly
# between k and k+1. Non-integer or out-of-window endpoints are unencodable:
# the resolver falls back to the host range scan for those (counted).
_I32_MIN = -(1 << 31)
_I32_MAX = (1 << 31) - 1


def _encode_endpoint(p, successor: bool = False) -> Optional[int]:
    from accord_tpu_torch.primitives.keyspace import _Successor
    if isinstance(p, _Successor):
        p = p.key
        successor = True
    if not isinstance(p, (int, np.integer)):
        return None
    v = int(p) + 1 if successor else int(p)
    if not (_I32_MIN < v < _I32_MAX):
        return None
    return v


def encode_interval(r) -> Optional[Tuple[int, int]]:
    """Range -> (start, end) int32 pair, or None when unencodable."""
    s = _encode_endpoint(r.start)
    e = _encode_endpoint(r.end)
    if s is None or e is None:
        return None
    return s, e


def encode_key_point_intervals(keys) -> Optional[List[Tuple[int, int, int]]]:
    """A KEY subject's owned keys as (key, start, end) point intervals
    [k, k+1), keeping the key alongside its entry so the finalized-CSR
    range path can attribute each device hit segment back to its real key
    (entries are 1:1 with keys; no merging). The interval pairs are exactly
    what encode_seekable_intervals emits for Keys, so feeding these to the
    candidate range kernel is bit-identical. None when any key is
    unencodable (the caller answers that subject's range deps host-side)."""
    out: List[Tuple[int, int, int]] = []
    for k in keys:
        s = _encode_endpoint(k)
        if s is None:
            return None
        out.append((k, s, s + 1))
    return out


def encode_seekable_intervals(seekables) -> Optional[List[Tuple[int, int]]]:
    """A subject's owned keys/ranges as interval pairs for the range kernel:
    keys become point intervals [k, k+1). None when any piece is
    unencodable (the caller answers that subject host-side)."""
    from accord_tpu_torch.primitives.keyspace import Keys
    out: List[Tuple[int, int]] = []
    if isinstance(seekables, Keys):
        for k in seekables:
            s = _encode_endpoint(k)
            if s is None:
                return None
            out.append((s, s + 1))
        return out
    for r in seekables:
        iv = encode_interval(r)
        if iv is None:
            return None
        out.append(iv)
    return out
