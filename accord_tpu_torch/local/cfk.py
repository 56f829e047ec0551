"""CommandsForKey: the per-key conflict registry.

Role-equivalent to the reference's local/cfk/CommandsForKey.java:171 -- for
each key, every witnessed transaction id with a compact status summary, in
TxnId order. This is the structure the deps-calculation hot loop scans
(mapReduceActive, CommandsForKey.java:910): PreAccept/Accept ask "which
witnessed txns conflict with and started before X?".

The host (CPU) scan lives here; the TPU data plane (accord_tpu_torch.ops) answers
the same query for micro-batches of transactions with interval bitmaps and a
boolean-matmul closure, behind the DepsResolver SPI. Keeping this registry's
contents reproducible from Commit/Apply messages is what makes the two paths
differentially testable.

The reference additionally compresses deps implicitly (store only missing[]
divergences); we keep explicit per-key id sets, pruned behind the
majority-durability floor (prune_below, driven by CommandStore.cleanup) --
the injected floor dep subsumes pruned entries' ordering, mirroring the
reference's prunedBefore.
"""
from __future__ import annotations

import enum
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from accord_tpu_torch.primitives.timestamp import Timestamp, TxnId, TxnKind


class CfkStatus(enum.IntEnum):
    """Compact per-key status summary (reference: cfk InternalStatus)."""
    WITNESSED = 0       # preaccepted/accepted: executeAt not final
    COMMITTED = 1       # executeAt decided
    APPLIED = 2         # executed + applied locally
    INVALIDATED = 3     # never executes; excluded from deps


class CfkInfo:
    __slots__ = ("status", "execute_at")

    def __init__(self, status: CfkStatus, execute_at: Optional[Timestamp]):
        self.status = status
        self.execute_at = execute_at

    def __repr__(self):
        return f"{self.status.name}@{self.execute_at!r}"


class CommandsForKey:
    __slots__ = ("key", "_infos", "_sorted", "max_applied_write",
                 "covered", "cover_watermark")

    def __init__(self, key):
        self.key = key
        self._infos: Dict[TxnId, CfkInfo] = {}
        self._sorted: Optional[List[TxnId]] = []
        # highest applied write executeAt for read-timestamp validation
        self.max_applied_write: Optional[Timestamp] = None
        # transitive-dependency elision (reference: CommandsForKey.java
        # "Transitive Dependency Elision", :146-151): ids PROVEN covered by a
        # committed write at this key -- a subject that depends on the
        # covering write is transitively ordered after them, so the scan
        # elides them from new dep sets. Unlike the reference (which executes
        # per-key in executeAt order) the repo executes by the agreed wait
        # graph, where an edge A->B only exists for B.executeAt < A.executeAt;
        # covering therefore requires BOTH that the id is in the cover's
        # agreed deps AND that it committed with executeAt below the cover's
        # (so the cover really waits it). Maps id -> (cover_seq, cover
        # executeAt): elision applies only to subjects whose started-before
        # bound is above the cover's executeAt -- the subject's own executeAt
        # (>= bound) then lands above the cover so its wait edge to the
        # cover is real, and executeAt >= txnId keeps the cover inside the
        # emitted dep set. cover_seq (the store's monotone cover counter)
        # lets the async device path elide only covers that existed when its
        # kernel snapshot was taken.
        self.covered: Dict[TxnId, Tuple[int, Timestamp]] = {}

    # -- registration --------------------------------------------------------
    def update(self, txn_id: TxnId, status: CfkStatus,
               execute_at: Optional[Timestamp]) -> None:
        info = self._infos.get(txn_id)
        if info is None:
            self._infos[txn_id] = CfkInfo(status, execute_at)
            self._sorted = None  # re-sort lazily
        else:
            if status > info.status:
                info.status = status
            if execute_at is not None:
                info.execute_at = execute_at
        if status == CfkStatus.APPLIED and txn_id.is_write:
            ea = execute_at if execute_at is not None else txn_id
            if self.max_applied_write is None or ea > self.max_applied_write:
                self.max_applied_write = ea

    def remove(self, txn_id: TxnId) -> None:
        if txn_id in self._infos:
            del self._infos[txn_id]
            self.covered.pop(txn_id, None)
            self._sorted = None

    def mark_covered(self, cover_seq: int, cover_id: TxnId,
                     cover_exec: Timestamp, dep_ids) -> None:
        """`cover_id` (a WRITE at this key) committed at `cover_exec` with
        agreed deps `dep_ids` at this key. An id is covered only when its
        OWN executeAt is decided and below the cover's: only then does the
        cover's wait graph really include it (see class comment)."""
        for t in dep_ids:
            if t in self.covered:
                continue
            info = self._infos.get(t)
            if info is None \
                    or info.status not in (CfkStatus.COMMITTED,
                                           CfkStatus.APPLIED) \
                    or info.execute_at is None \
                    or not info.execute_at < cover_exec:
                continue
            self.covered[t] = (cover_seq, cover_exec)

    def prune_below(self, floor: Timestamp) -> List[TxnId]:
        """Drop APPLIED/INVALIDATED entries wholly below `floor` (the
        majority-durable sync point for this key): the injected floor dep
        subsumes their ordering for every future subject, so the scan no
        longer needs them (reference: cfk pruning via prunedBefore,
        local/cfk/Pruning.java:41, CommandsForKey.java:113-146). Entries not
        yet applied stay regardless of age. Returns the pruned ids (the
        store mirrors the removal into the device arena)."""
        pruned = [
            t for t, info in self._infos.items()
            if info.status in (CfkStatus.APPLIED, CfkStatus.INVALIDATED)
            and t < floor
            and (info.execute_at is None or info.execute_at < floor)]
        for t in pruned:
            del self._infos[t]
            self.covered.pop(t, None)
        if pruned:
            self._sorted = None
        return pruned

    # -- queries -------------------------------------------------------------
    def _ids(self) -> List[TxnId]:
        if self._sorted is None:
            self._sorted = sorted(self._infos)
        return self._sorted

    def get(self, txn_id: TxnId) -> Optional[CfkInfo]:
        return self._infos.get(txn_id)

    def is_empty(self) -> bool:
        return not self._infos

    def __len__(self) -> int:
        return len(self._infos)

    def conflicts_before(self, subject: TxnId, before: Timestamp) -> Iterator[TxnId]:
        """All witnessed txn ids t != subject with t < before that `subject`'s
        kind witnesses and that may still execute (not invalidated). This is
        the deps-calculation scan (reference mapReduceActive semantics:
        STARTED_BEFORE(before) + kind filter), with transitive-dependency
        elision: ids covered by a committed write's agreed deps are dropped
        whenever every covering write is itself below `before` (and hence in
        the emitted set) -- this is what keeps dep sets bounded by the
        conflicts since the last committed write instead of the full
        conflict count between durability rounds."""
        kind = subject.kind
        covered = self.covered
        for t in self._ids():
            if not t < before:
                break
            if t == subject:
                continue
            info = self._infos[t]
            if info.status == CfkStatus.INVALIDATED:
                continue
            cov = covered.get(t)
            if cov is not None and cov[1] < before:
                continue
            if kind.witnesses(t.kind):
                yield t

    def max_conflict(self, subject_kind: TxnKind) -> Optional[Timestamp]:
        """Max (txn_id, execute_at) among witnessed conflicting txns."""
        out: Optional[Timestamp] = None
        for t, info in self._infos.items():
            if info.status == CfkStatus.INVALIDATED:
                continue
            if not subject_kind.witnesses(t.kind) and not t.kind.witnesses(subject_kind):
                continue
            c = info.execute_at if info.execute_at is not None and info.execute_at > t else t
            if out is None or c > out:
                out = c
        return out

    def __repr__(self):
        return f"CFK({self.key}: {len(self._infos)} txns)"
