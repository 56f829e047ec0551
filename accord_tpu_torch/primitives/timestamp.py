"""Protocol timestamps: Timestamp, TxnId, Ballot.

Role-equivalent to the reference's hybrid-logical-clock value types
(primitives/Timestamp.java:28-90, TxnId.java:33, Ballot.java): a globally
unique, roughly-time-ordered identifier. Total order is (epoch, hlc, flags,
node) -- node id breaks ties deterministically, which is what makes the whole
protocol (and the burn test's replayability) deterministic.

TPU-first encoding: every timestamp packs losslessly into two int64 lanes
(msb = epoch<<16 | flags, lsb = hlc<<16 | node), the struct-of-arrays layout
consumed by the device deps kernels (accord_tpu_torch.ops). The reference uses the
same two-long packing; here it is the *tensor* layout, not a memory trick.
"""
from __future__ import annotations

import enum
import os
from typing import Optional, Tuple

# Node ids are small ints (reference: Node.Id, local/Node.java:104).
NodeId = int

_FLAGS_BITS = 16
_NODE_BITS = 16
_HLC_BITS = 48
_EPOCH_BITS = 48

# Flag layout inside the 16-bit flags field (TxnId only; plain Timestamps and
# Ballots carry flags == 0 unless REJECTED):
#   bits 0..2  TxnKind ordinal
#   bit  3     Domain (0 = Key, 1 = Range)
_KIND_MASK = 0x7
_DOMAIN_SHIFT = 3
REJECTED_FLAG = 1 << 15  # mirrors Timestamp.REJECTED (used by PreAccept nacks)


class Domain(enum.IntEnum):
    KEY = 0
    RANGE = 1


# interning table for wire-decoded timestamps (see Timestamp.__reduce__);
# keyed by (class, fields) so TxnId/Ballot/Timestamp never alias
_INTERNED: dict = {}
_INTERN_CAP = 1 << 20


class TxnKind(enum.IntEnum):
    """Transaction kinds and their conflict-witnessing rules (reference:
    primitives/Txn.java:53 Kind / :125 Kinds)."""

    READ = 0
    WRITE = 1
    EPHEMERAL_READ = 2
    SYNC_POINT = 3
    EXCLUSIVE_SYNC_POINT = 4
    LOCAL_ONLY = 5

    def witnesses(self, other: "TxnKind") -> bool:
        """Does a txn of kind `self` include a conflicting txn of kind `other`
        in its deps? Reads witness only writes; writes and sync points witness
        reads and writes; exclusive sync points witness every globally visible
        kind (reference: Txn.Kind.witnesses, primitives/Txn.java:224-236)."""
        return other in _WITNESSES[self]

    def witnessed_by(self, other: "TxnKind") -> bool:
        return self in _WITNESSES[other]

    @property
    def is_write(self) -> bool:
        return self is TxnKind.WRITE

    @property
    def is_read(self) -> bool:
        return self in (TxnKind.READ, TxnKind.EPHEMERAL_READ)

    @property
    def is_sync_point(self) -> bool:
        return self in (TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT)

    @property
    def awaits_only_deps(self) -> bool:
        """Executes only after its deps, with no logical executeAt
        (reference: Txn.Kind.awaitsOnlyDeps)."""
        return self in (TxnKind.EXCLUSIVE_SYNC_POINT, TxnKind.EPHEMERAL_READ)

    @property
    def is_durable(self) -> bool:
        """Ephemeral reads leave no durable state."""
        return self is not TxnKind.EPHEMERAL_READ


# Exact mirror of the reference's witnesses() table (primitives/Txn.java:224):
#   Read/EphemeralRead -> Ws; Write/SyncPoint -> RsOrWs;
#   ExclusiveSyncPoint -> AnyGloballyVisible.
_RW = frozenset({TxnKind.READ, TxnKind.WRITE})
_W = frozenset({TxnKind.WRITE})
_ANY_GLOBALLY_VISIBLE = frozenset({TxnKind.READ, TxnKind.WRITE,
                                   TxnKind.SYNC_POINT, TxnKind.EXCLUSIVE_SYNC_POINT})
_WITNESSES = {
    TxnKind.READ: _W,
    TxnKind.EPHEMERAL_READ: _W,
    TxnKind.WRITE: _RW,
    TxnKind.SYNC_POINT: _RW,
    TxnKind.EXCLUSIVE_SYNC_POINT: _ANY_GLOBALLY_VISIBLE,
    TxnKind.LOCAL_ONLY: frozenset(),
}


class Timestamp:
    """(epoch, hlc, flags, node) with total order. Immutable BY CONVENTION:
    nothing in the codebase mutates a constructed timestamp (instances are
    shared freely, interned across the wire boundary, and used as dict/set
    keys -- mutating one would corrupt every structure holding it)."""

    __slots__ = ("epoch", "hlc", "flags", "node", "_cmp", "_hash")

    def __init__(self, epoch: int, hlc: int, flags: int, node: NodeId):
        # bounds are enforced where values originate (unique_now, create,
        # unpack); re-validating on every wire-decode reconstruction is one
        # of the simulator's top costs -- as is any extra work here (this is
        # the hottest constructor in the system)
        self.epoch = epoch
        self.hlc = hlc
        self.flags = flags
        self.node = node
        # one order-preserving int for the (epoch, hlc, flags, node) total
        # order: comparisons and hashing are the simulator's hottest ops
        cmp = (((epoch << _HLC_BITS) | hlc) << (_FLAGS_BITS + _NODE_BITS)) \
            | (flags << _NODE_BITS) | node
        self._cmp = cmp
        self._hash = hash(cmp)

    if os.environ.get("ACCORD_TPU_PARANOIA", "linear") == "superlinear":
        # immutability enforced only at SUPERLINEAR paranoia (the test tier:
        # instances are globally interned and shared across nodes/messages/
        # dict keys, so a silent mutation would corrupt every structure
        # holding one). This is the hottest constructor in the system -- the
        # guard costs ~3x, so linear/production keep the guard-free path.
        def __setattr__(self, name, value):
            if hasattr(self, name):  # slots are write-once: init sets each once
                raise AttributeError(
                    f"{type(self).__name__} is immutable (tried to set {name})")
            object.__setattr__(self, name, value)

    def __reduce__(self):
        # the wire boundary (sim/wire.py) pickles every message; interning
        # reconstructed timestamps is safe (immutable) and collapses the
        # dominant decode cost -- deps sets repeat the same ids endlessly
        return (type(self)._intern, (self.epoch, self.hlc, self.flags, self.node))

    @classmethod
    def _intern(cls, epoch: int, hlc: int, flags: int, node: NodeId) -> "Timestamp":
        key = (cls, epoch, hlc, flags, node)
        t = _INTERNED.get(key)
        if t is None:
            if len(_INTERNED) >= _INTERN_CAP:
                _INTERNED.clear()  # crude bound; hit rate recovers quickly
            t = _INTERNED[key] = cls(epoch, hlc, flags, node)
        return t

    # -- ordering ------------------------------------------------------------
    def _key(self) -> Tuple[int, int, int, int]:
        return (self.epoch, self.hlc, self.flags, self.node)

    def __lt__(self, other: "Timestamp") -> bool:
        return self._cmp < other._cmp

    def __le__(self, other: "Timestamp") -> bool:
        return self._cmp <= other._cmp

    def __gt__(self, other: "Timestamp") -> bool:
        return self._cmp > other._cmp

    def __ge__(self, other: "Timestamp") -> bool:
        return self._cmp >= other._cmp

    def __eq__(self, other) -> bool:
        return isinstance(other, Timestamp) and self._cmp == other._cmp

    def __hash__(self) -> int:
        return self._hash

    # -- rejection flag (reference: Timestamp.REJECTED_FLAG / asRejected) ----
    @property
    def is_rejected(self) -> bool:
        return bool(self.flags & REJECTED_FLAG)

    def as_rejected(self) -> "Timestamp":
        return Timestamp(self.epoch, self.hlc, self.flags | REJECTED_FLAG, self.node)

    # -- derivation ----------------------------------------------------------
    def with_next_hlc(self) -> "Timestamp":
        return Timestamp(self.epoch, self.hlc + 1, 0, self.node)

    def with_node(self, node: NodeId) -> "Timestamp":
        return Timestamp(self.epoch, self.hlc, self.flags, node)

    def with_epoch_at_least(self, epoch: int) -> "Timestamp":
        return self if self.epoch >= epoch else Timestamp(epoch, self.hlc, self.flags, self.node)

    @staticmethod
    def merge_max(a: Optional["Timestamp"], b: Optional["Timestamp"]) -> Optional["Timestamp"]:
        if a is None:
            return b
        if b is None:
            return a
        return a if a >= b else b

    @staticmethod
    def merge_witnessed(a: "Timestamp", b: "Timestamp") -> "Timestamp":
        """Max of two witnessed timestamps with STICKY rejection: if either
        vote was rejected (sync-point floor / expiry), the merged result stays
        rejected even when the other vote has a higher hlc -- otherwise a
        later clean unique_now from a sibling store would silently mask the
        rejection and let a txn commit behind an ExclusiveSyncPoint floor."""
        m = a if a >= b else b
        if (a.is_rejected or b.is_rejected) and not m.is_rejected:
            m = m.as_rejected()
        return m

    # -- tensor encoding -----------------------------------------------------
    def pack(self) -> Tuple[int, int]:
        """(msb, lsb) int64 pair, order-preserving when compared as unsigned
        (msb, lsb) pairs -- the struct-of-arrays layout the device kernels use.
        msb = epoch(48) . hlc_hi(16); lsb = hlc_lo(32) . flags(16) . node(16)."""
        msb = (self.epoch << 16) | (self.hlc >> 32)
        lsb = ((self.hlc & 0xFFFFFFFF) << 32) | (self.flags << 16) | self.node
        return msb, lsb

    @classmethod
    def unpack(cls, msb: int, lsb: int) -> "Timestamp":
        epoch = msb >> 16
        hlc = ((msb & 0xFFFF) << 32) | (lsb >> 32)
        return cls(epoch, hlc, (lsb >> 16) & 0xFFFF, lsb & 0xFFFF)

    def __repr__(self):
        return f"[{self.epoch},{self.hlc},{self.flags},{self.node}]"


Timestamp.NONE = Timestamp(0, 0, 0, 0)
Timestamp.MAX = Timestamp((1 << _EPOCH_BITS) - 1, (1 << _HLC_BITS) - 1, (1 << _FLAGS_BITS) - 1, (1 << _NODE_BITS) - 1)


class TxnId(Timestamp):
    """Timestamp whose flags encode TxnKind + Domain (reference:
    primitives/TxnId.java:81-99)."""

    __slots__ = ()

    @classmethod
    def create(cls, epoch: int, hlc: int, node: NodeId, kind: TxnKind,
               domain: Domain = Domain.KEY) -> "TxnId":
        flags = int(kind) | (int(domain) << _DOMAIN_SHIFT)
        return cls(epoch, hlc, flags, node)

    @property
    def kind(self) -> TxnKind:
        # table lookup: enum __call__ is ~5x slower and this is called on
        # every witness test / waiting-on edge update
        return _KIND_MEMBERS[self.flags & _KIND_MASK]

    @property
    def domain(self) -> Domain:
        return _DOMAIN_MEMBERS[(self.flags >> _DOMAIN_SHIFT) & 1]

    @property
    def is_write(self) -> bool:
        return self.kind.is_write

    @property
    def is_read(self) -> bool:
        return self.kind.is_read

    def witnesses(self, other: "TxnId") -> bool:
        return self.kind.witnesses(other.kind)

    def as_timestamp(self) -> Timestamp:
        return Timestamp(self.epoch, self.hlc, self.flags, self.node)

    @classmethod
    def from_timestamp(cls, ts: Timestamp) -> "TxnId":
        return cls(ts.epoch, ts.hlc, ts.flags, ts.node)

    def __repr__(self):
        return f"{self.kind.name[0]}{'r' if self.domain == Domain.RANGE else ''}[{self.epoch},{self.hlc},{self.node}]"


_KIND_MEMBERS = tuple(TxnKind) + (TxnKind.LOCAL_ONLY,) * (8 - len(TxnKind))
_DOMAIN_MEMBERS = (Domain.KEY, Domain.RANGE)

TxnId.NONE = TxnId(0, 0, 0, 0)
# MAX sentinel keeps a VALID kind/domain encoding (LOCAL_ONLY + RANGE) so that
# .kind/.domain/repr never crash; no real TxnId carries higher flag bits, so
# it still compares above every real id at equal (epoch, hlc).
TxnId.MAX = TxnId.create((1 << _EPOCH_BITS) - 1, (1 << _HLC_BITS) - 1,
                         (1 << _NODE_BITS) - 1, TxnKind.LOCAL_ONLY, Domain.RANGE)


class Ballot(Timestamp):
    """Paxos-style promise token used by Accept and Recovery rounds
    (reference: primitives/Ballot.java)."""

    __slots__ = ()

    @classmethod
    def from_timestamp(cls, ts: Timestamp) -> "Ballot":
        return cls(ts.epoch, ts.hlc, ts.flags, ts.node)


Ballot.ZERO = Ballot(0, 0, 0, 0)
Ballot.MAX = Ballot.from_timestamp(Timestamp.MAX)
