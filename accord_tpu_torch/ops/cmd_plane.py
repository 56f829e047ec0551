"""Device-resident coordination plane: the per-txn protocol state machines
of local/commands.py (PreAccept witness, Accept ballot checks, Commit/Apply
status promotions) restructured as SoA arena columns on device and evaluated
in batches by ONE kernel dispatch (ops/kernels.cmd_tick).

The Python handlers stay authoritative for everything the device cannot hold
(routes, deps objects, wait graphs, progress logs): a device-evaluated op is
followed by a HOST RESIDUAL that replays the handler's side effects with the
decision (witnessed timestamp, outcome code, status promotion) taken from the
kernel output instead of recomputed. The differential contract -- asserted by
tests/test_cmd_plane.py -- is that cmd_plane=True and cmd_plane=False produce
bit-identical status histories, executeAt choices and HLC clocks.

Arena columns (int lanes; generation-pinned compaction; per-field dirty masks
uploaded through ops/deltas.flush_lane, same discipline as the exec
plane):

    status      i32[cap]     Status ladder value
    flags       i32[cap]     bit0 = definition recorded (cmd.txn is not None)
    promised    i32[cap,3]   promised ballot lanes
    accepted    i32[cap,3]   accepted ballot lanes
    execute_at  i32[cap,3]   executeAt lanes (INT32_MIN lanes == None)
    durability  i32[cap]     Durability ladder value
    kmax        i32[kcap,3]  per-key max-conflict lanes (MaxConflicts twin)
    kmax_valid  bool[kcap]

Timestamps ride ABSOLUTE base-(0,0) lanes -- lane0 epoch, lane1 hlc, lane2
(flags << 16 | node) - 2^31 -- so TxnId lanes double as txn_id.as_timestamp()
(TxnId.as_timestamp keeps the flags) and the packed lex order equals the host
Timestamp total order.

Admission is conservative: an op the kernel cannot evaluate exactly (reject /
truncation floors active, range-domain conflicts, sync points, out-of-window
lanes, too many owned keys) falls back to the host handler and is counted in
cmd_plane_fallbacks. Order is preserved: an inadmissible op flushes the
pending device run first.

Port: the plane lives on an explicit device (`device=None` is the card, and
raises without one; "cpu" runs the kernels' plain versions). The columns
are torch tensors there; a full rebuild uploads them through
`kernels.upload` (pinned, non_blocking) and dirty rows go through
`deltas.flush_lanes` (K4: one launch a flush and chunk for every dirty
lane). A dispatch is ONE cmd_tick launch (K10,
csrc/cmd_tick.cu) and ONE blocking pinned readback of its result block
(out_code, out_status, out_ts, the op-sized chains, clock, csum): the
reference is synchronous here (node._last_hlc = clock). The shadow sync
takes each touched row's and kid's new values from its last writer's
chain, which is the column row by construction, instead of reading whole
columns back. The recovery scan is K11 (csrc/recovery_scan.cu), the
repair scatter K12 (csrc/cmd_repair.cu): collect_repair's block goes to
`kernels.cmd_repair` and its columns to adopt_repair. There is nothing to
compile ahead beyond nvcc at first use, so the reference's
warmup_cmd_plane has no counterpart here.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from accord_tpu_torch.local.status import Durability, Status
from accord_tpu_torch.obs.metrics import MetricsRegistry, RegCounter, RegTimer
from accord_tpu_torch.primitives.keyspace import Keys
from accord_tpu_torch.primitives.timestamp import (Ballot, Timestamp, TxnId,
                                             TxnKind)

_NEG = np.iinfo(np.int32).min
_WINDOW = (1 << 31) - 1
_LANE2_OFF = 1 << 31
# Ballot.ZERO's absolute lanes: lane2 = (0 << 16 | 0) - 2^31, NOT 0 -- a
# zeroed lane2 would compare above every real ballot
_BAL0 = (0, 0, -_LANE2_OFF)

# the kernel mirrors these ladders as plain ints; a drifting enum would turn
# into silent protocol corruption, so pin them at import
from accord_tpu_torch.ops.kernels import (  # noqa: E402
    CMD_F_DEPS_EMPTY, CMD_F_EPOCH_OK, CMD_F_EXPIRED, CMD_F_MSG_HAS_TXN,
    CMD_F_PERMIT_FAST, CMD_F_VALID, CMD_OP_ACCEPT, CMD_OP_APPLY,
    CMD_OP_COMMIT, CMD_OP_PREACCEPT, CMD_OUT_INCONSISTENT_BIT,
    CMD_OUT_REDUNDANT, CMD_OUT_REJECTED_BALLOT, CMD_OUT_SUCCESS,
    CMD_OUT_TRUNCATED, CMD_OUT_WAS_STABLE_BIT, CMD_ROW_LANES,
    CMD_ST_ACCEPTED, CMD_ST_APPLIED, CMD_ST_INVALIDATED,
    CMD_ST_PRE_ACCEPTED, CMD_ST_PRE_APPLIED, CMD_ST_READY, CMD_ST_STABLE,
    CMD_ST_TRUNCATED, cmd_checksum_host, cmd_op_tier, cmd_tick_readback,
    upload)
from accord_tpu_torch.ops.resolver import _DevBuf, _resolve_device  # noqa: E402

assert int(Status.PRE_ACCEPTED) == CMD_ST_PRE_ACCEPTED
assert int(Status.ACCEPTED) == CMD_ST_ACCEPTED
assert int(Status.STABLE) == CMD_ST_STABLE
assert int(Status.READY_TO_EXECUTE) == CMD_ST_READY
assert int(Status.PRE_APPLIED) == CMD_ST_PRE_APPLIED
assert int(Status.APPLIED) == CMD_ST_APPLIED
assert int(Status.INVALIDATED) == CMD_ST_INVALIDATED
assert int(Status.TRUNCATED) == CMD_ST_TRUNCATED


def _enc(ts) -> Tuple[int, int, int]:
    """Timestamp/TxnId/Ballot -> absolute base-(0,0) lanes."""
    return (ts.epoch, ts.hlc, ((ts.flags << 16) | ts.node) - _LANE2_OFF)


def _dec(l0: int, l1: int, l2: int) -> Timestamp:
    v = int(l2) + _LANE2_OFF
    return Timestamp(int(l0), int(l1), v >> 16, v & 0xFFFF)


def _in_window(ts) -> bool:
    return 0 <= ts.epoch < _WINDOW and 0 <= ts.hlc < _WINDOW


class CmdOp:
    """One protocol transition queued for batched device evaluation."""

    __slots__ = ("kind", "txn_id", "txn", "route", "ballot", "execute_at",
                 "deps", "writes", "result", "keys", "owned")

    def __init__(self, kind, txn_id, txn=None, route=None,
                 ballot=Ballot.ZERO, execute_at=None, deps=None,
                 writes=None, result=None, keys=None):
        self.kind = kind
        self.txn_id = txn_id
        self.txn = txn
        self.route = route
        self.ballot = ballot
        self.execute_at = execute_at
        self.deps = deps
        self.writes = writes
        self.result = result
        self.keys = keys
        self.owned = None   # filled by admission

    @staticmethod
    def preaccept(txn_id, txn, route, ballot=Ballot.ZERO) -> "CmdOp":
        return CmdOp(CMD_OP_PREACCEPT, txn_id, txn=txn, route=route,
                     ballot=ballot)

    @staticmethod
    def accept(txn_id, ballot, route, keys, execute_at,
               deps=None) -> "CmdOp":
        return CmdOp(CMD_OP_ACCEPT, txn_id, route=route, ballot=ballot,
                     execute_at=execute_at, deps=deps, keys=keys)

    @staticmethod
    def commit(txn_id, route, txn, execute_at, deps) -> "CmdOp":
        return CmdOp(CMD_OP_COMMIT, txn_id, txn=txn, route=route,
                     execute_at=execute_at, deps=deps)

    @staticmethod
    def apply(txn_id, route, txn, execute_at, deps, writes=None,
              result=None) -> "CmdOp":
        return CmdOp(CMD_OP_APPLY, txn_id, txn=txn, route=route,
                     execute_at=execute_at, deps=deps, writes=writes,
                     result=result)


class CmdResult:
    """Outcome of one evaluated op: handler-equivalent outcome enum, the
    resulting Status, the witnessed/echoed executeAt, and the raw code."""

    __slots__ = ("outcome", "status", "execute_at", "code")

    def __init__(self, outcome, status, execute_at, code):
        self.outcome = outcome
        self.status = status
        self.execute_at = execute_at
        self.code = code

    def __repr__(self):
        return (f"CmdResult({self.outcome}, {self.status}, "
                f"{self.execute_at}, code={self.code})")


_LANES = ("status", "flags", "promised", "accepted", "execute_at",
          "durability")


class CmdPlane:
    """Per-store device command arena + batched transition evaluator.

    apply_to_store=True (the protocol mode): every device decision is
    followed by a host residual replaying the handler's side effects, so
    the Command objects / cfks / wait graphs stay authoritative and
    bit-identical to the Python path. apply_to_store=False (the arena-only
    bench mode): the arena IS the state -- empty-deps promotions
    (STABLE -> READY_TO_EXECUTE, PRE_APPLIED -> APPLIED + durability merge)
    run on device via cmd_tick(promote=True).

    authoritative=True (the cluster-tick mode, ClusterConfig
    `cmd_plane_authoritative`): device promotions run even WITH the store
    attached -- the arena decides status transitions and the host residuals
    only replay the side effects the device cannot hold (Command objects,
    cfks, wait graphs). Safe because cmd_tick's predicates are >=-band
    status compares, so arena rows running ahead of the store (STABLE ->
    READY_TO_EXECUTE, PRE_APPLIED -> APPLIED) never change a decision;
    `tests/test_cmd_plane.py` gates this differentially.
    """

    dispatches = RegCounter("cmd_plane_dispatches")
    upload_bytes = RegCounter("cmd_plane_upload_bytes")
    fastpath_device_evals = RegCounter("cmd_fastpath_device_evals")
    fallbacks = RegCounter("cmd_plane_fallbacks")
    checksum_mismatches = RegCounter("cmd_plane_checksum_mismatches")
    compactions = RegCounter("cmd_plane_compactions")
    deferred_spans = RegCounter("cmd_deferred_spans")
    deferred_ops = RegCounter("cmd_deferred_ops")
    defer_retired = RegCounter("cmd_defer_retired")
    flush_s = RegTimer("cmd_plane_flush_s")
    # recovery-candidate scan (kernels.recovery_scan): one device query per
    # progress sweep instead of the host walk over every live waiter;
    # checksum mismatch / out_cap overflow fall back to the host twin,
    # counted (the exec-plane degradation contract)
    recovery_scan_dispatches = RegCounter("recovery_scan_dispatches")
    recovery_scan_candidates = RegCounter("recovery_scan_candidates")
    recovery_scan_fallbacks = RegCounter("recovery_scan_fallbacks")
    recovery_scan_overflows = RegCounter("recovery_scan_overflows")
    recovery_scan_device_s = RegTimer("recovery_scan_device_s")
    recovery_scan_host_s = RegTimer("recovery_scan_host_s")

    def __init__(self, store, initial_cap: int = 1024, key_cap: int = 1024,
                 kpad: int = 4, apply_to_store: bool = True,
                 authoritative: bool = False, device=None):
        self.store = store
        self.device = _resolve_device(device, "CmdPlane")
        self.kpad = int(kpad)
        self.apply_to_store = bool(apply_to_store)
        self.authoritative = bool(authoritative)
        self.metrics = MetricsRegistry()
        self._lock = threading.RLock()

        cap, kcap = int(initial_cap), int(key_cap)
        self.cap, self.kcap = cap, kcap
        self.status_h = np.zeros(cap, np.int32)
        self.flags_h = np.zeros(cap, np.int32)
        self.promised_h = np.tile(np.asarray(_BAL0, np.int32), (cap, 1))
        self.accepted_h = np.tile(np.asarray(_BAL0, np.int32), (cap, 1))
        self.ea_h = np.full((cap, 3), _NEG, np.int32)
        self.dur_h = np.zeros(cap, np.int32)
        self.kmax_h = np.full((kcap, 3), _NEG, np.int32)
        self.kvalid_h = np.zeros(kcap, bool)

        self.row_of: Dict[TxnId, int] = {}
        self.kid_of: Dict[object, int] = {}
        # row -> TxnId reverse map (dense, rows allocate sequentially):
        # lets the recovery scan translate candidate row lists back to
        # TxnIds without a per-sweep dict inversion
        self.tid_by_row: List[TxnId] = []
        self.n_rows = 0
        self.gen = 0
        self._poison: set = set()
        self._dirty: Dict[str, set] = {name: set() for name in _LANES}
        self._kdirty: set = set()
        self._device = None        # dict of device columns once built
        self._device_stale = True  # full rebuild pending
        # last-arena-touch times (sim ms) feeding the recovery scan's stall
        # predicate; a separate column OUTSIDE _LANES so the repair block's
        # 18-array arity is untouched -- flushed only at scan time
        self.touched_h = np.zeros(cap, np.int32)
        self._tdirty: set = set()
        self._touched_dev = None
        self._touched_stale = True
        self._tnode = None         # cached store.node handle for _touch
        self._rec_tiers = None     # OutCapTiers, built on first device scan

    # -- shadows <-> store ---------------------------------------------------

    def _shadow_of(self, name: str) -> np.ndarray:
        return {"status": self.status_h, "flags": self.flags_h,
                "promised": self.promised_h, "accepted": self.accepted_h,
                "execute_at": self.ea_h, "durability": self.dur_h}[name]

    def _sync_row(self, row: int, cmd) -> None:
        """Diff a Command's protocol fields into the shadow columns, marking
        only genuinely changed lanes dirty."""
        tid = cmd.txn_id
        for ts in (cmd.promised, cmd.accepted_ballot, cmd.execute_at):
            if ts is not None and not _in_window(ts):
                self._poison.add(tid)
                return
        vals = {
            "status": np.int32(int(cmd.status)),
            "flags": np.int32(1 if cmd.txn is not None else 0),
            "promised": np.asarray(_enc(cmd.promised), np.int32),
            "accepted": np.asarray(_enc(cmd.accepted_ballot), np.int32),
            "execute_at": (np.asarray(_enc(cmd.execute_at), np.int32)
                           if cmd.execute_at is not None
                           else np.full(3, _NEG, np.int32)),
            "durability": np.int32(int(cmd.durability)),
        }
        changed = False
        for name, v in vals.items():
            sh = self._shadow_of(name)
            if not np.array_equal(sh[row], v):
                sh[row] = v
                self._dirty[name].add(row)
                changed = True
        if changed:
            self._touch(row)

    def _touch(self, row: int) -> None:
        """Stamp a row's last-arena-touch time (recovery scan stall ages);
        a pure sim-clock read, so touching never perturbs determinism.
        Rides every changed _sync_row, so it stays lean: the node handle is
        cached on first sight and the stamp is a plain-int store."""
        node = self._tnode
        if node is None:
            node = self._tnode = getattr(self.store, "node", None)
            if node is None:
                return
        now = int(node.now_millis())
        if self.touched_h[row] != now:
            self.touched_h[row] = now
            self._tdirty.add(row)

    def on_status(self, cmd) -> None:
        """notify_listeners hook: refresh an EXISTING row from host-side
        transitions (recovery, invalidation, durability, the residuals
        themselves). Rows are created lazily at the first plane op."""
        row = self.row_of.get(cmd.txn_id)
        if row is not None:
            self._sync_row(row, cmd)

    def on_max_conflict(self, seekables, ts: Timestamp) -> None:
        """store.update_max_conflicts hook: keep seeded kid slots tracking
        the host per-key MaxConflicts fold."""
        if not isinstance(seekables, Keys) or not _in_window(ts):
            return
        lanes = np.asarray(_enc(ts), np.int32)
        for k in seekables:
            kid = self.kid_of.get(k)
            if kid is None:
                continue
            if not self.kvalid_h[kid] \
                    or tuple(self.kmax_h[kid]) < tuple(int(x) for x in lanes):
                self.kmax_h[kid] = lanes
                self.kvalid_h[kid] = True
                self._kdirty.add(kid)

    # -- row / kid allocation ------------------------------------------------

    def _grow_rows(self, need: int) -> None:
        cap = self.cap
        while cap < need:
            cap *= 2
        grow = cap - self.cap
        self.status_h = np.concatenate([self.status_h,
                                        np.zeros(grow, np.int32)])
        self.flags_h = np.concatenate([self.flags_h,
                                       np.zeros(grow, np.int32)])
        self.promised_h = np.concatenate(
            [self.promised_h,
             np.tile(np.asarray(_BAL0, np.int32), (grow, 1))])
        self.accepted_h = np.concatenate(
            [self.accepted_h,
             np.tile(np.asarray(_BAL0, np.int32), (grow, 1))])
        self.ea_h = np.concatenate(
            [self.ea_h, np.full((grow, 3), _NEG, np.int32)])
        self.dur_h = np.concatenate([self.dur_h, np.zeros(grow, np.int32)])
        self.touched_h = np.concatenate([self.touched_h,
                                         np.zeros(grow, np.int32)])
        self.cap = cap
        self._device_stale = True
        self._touched_stale = True

    def _row_for(self, txn_id: TxnId) -> int:
        row = self.row_of.get(txn_id)
        if row is not None:
            return row
        if self.n_rows >= self.cap:
            self._grow_rows(self.n_rows + 1)
        row = self.n_rows
        self.n_rows += 1
        self.row_of[txn_id] = row
        self.tid_by_row.append(txn_id)
        cmd = self.store.command_if_present(txn_id)
        if cmd is not None:
            # seed clean, then diff: a fresh row starts at the ladder floor,
            # and _sync_row dirties exactly the lanes the command moved
            self.status_h[row] = 0
            self.flags_h[row] = 0
            self.promised_h[row] = _BAL0
            self.accepted_h[row] = _BAL0
            self.ea_h[row] = _NEG
            self.dur_h[row] = 0
            self._sync_row(row, cmd)
        # no command: the row IS the device's resting default (fresh rows
        # past n_rows are never kernel-written), so nothing to upload
        return row

    def _kid_for(self, key) -> int:
        kid = self.kid_of.get(key)
        if kid is not None:
            return kid
        if len(self.kid_of) >= self.kcap:
            kcap = self.kcap * 2
            self.kmax_h = np.concatenate(
                [self.kmax_h, np.full((kcap - self.kcap, 3), _NEG,
                                      np.int32)])
            self.kvalid_h = np.concatenate(
                [self.kvalid_h, np.zeros(kcap - self.kcap, bool)])
            self.kcap = kcap
            self._device_stale = True
        kid = len(self.kid_of)
        self.kid_of[key] = kid
        seed = self.store.max_conflicts_by_key.get(key)
        if seed is not None and _in_window(seed):
            self.kmax_h[kid] = np.asarray(_enc(seed), np.int32)
            self.kvalid_h[kid] = True
        self._kdirty.add(kid)
        return kid

    def compact(self) -> None:
        """Generation-pinned compaction: drop rows whose commands reached a
        resting state (APPLIED / terminal) -- the store's Command objects
        keep the full record, so a late redundant delivery just re-seeds a
        fresh row. Ops hold TxnIds, not row indices, and rows resolve at
        dispatch time, so compaction between op construction and eval_batch
        is safe (the differential test drives exactly that interleaving)."""
        if not self.apply_to_store:
            raise RuntimeError("arena-only plane cannot compact: the arena "
                               "is the sole copy of the state")
        with self._lock:
            keep = [(tid, row) for tid, row in sorted(
                self.row_of.items(), key=lambda kv: kv[1])
                if self.status_h[row] < CMD_ST_APPLIED]
            new_row_of: Dict[TxnId, int] = {}
            for i, (tid, old) in enumerate(keep):
                for name in _LANES:
                    sh = self._shadow_of(name)
                    sh[i] = sh[old]
                self.touched_h[i] = self.touched_h[old]
                new_row_of[tid] = i
            n = len(keep)
            self.status_h[n:self.n_rows] = 0
            self.flags_h[n:self.n_rows] = 0
            self.promised_h[n:self.n_rows] = _BAL0
            self.accepted_h[n:self.n_rows] = _BAL0
            self.ea_h[n:self.n_rows] = _NEG
            self.dur_h[n:self.n_rows] = 0
            self.touched_h[n:self.n_rows] = 0
            self.row_of = new_row_of
            self.tid_by_row = [tid for tid, _old in keep]
            self.n_rows = n
            self.gen += 1
            for name in _LANES:
                self._dirty[name].clear()
            self._tdirty.clear()
            self._device_stale = True
            self._touched_stale = True
            self.compactions += 1

    # -- admission -----------------------------------------------------------

    def _store_ok(self) -> bool:
        s = self.store
        return (s.truncated_before.is_empty()
                and s.reject_before.is_empty()
                and s.max_conflicts.is_empty())

    def _admit(self, op: CmdOp, store_ok: bool) -> bool:
        """Exact-evaluation precondition; False routes the op to the host
        handler. Computes op.owned (the kid-slot key set) as a side effect.
        `store_ok` is _store_ok() hoisted out of the batch loop (the floors
        it checks only move through host handlers, never mid-batch)."""
        if not store_ok or op.txn_id in self._poison:
            return False
        if not _in_window(op.txn_id) or not _in_window(op.ballot):
            return False
        if op.execute_at is not None and not _in_window(op.execute_at):
            return False
        if op.kind == CMD_OP_PREACCEPT:
            if op.txn_id.kind is TxnKind.EXCLUSIVE_SYNC_POINT \
                    or op.txn is None:
                return False
            owned = self.store.owned(op.txn.keys)
        elif op.kind == CMD_OP_ACCEPT:
            if op.keys is None or op.execute_at is None:
                return False
            owned = self.store.owned(op.keys)
        else:   # commit / apply
            if op.execute_at is None or op.route is None:
                return False
            cmd = self.store.command_if_present(op.txn_id)
            known = cmd.txn if cmd is not None else None
            if known is not None and op.txn is not None \
                    and known.keys != op.txn.keys:
                return False   # union could change the registered key set
            body = op.txn if op.txn is not None else known
            if body is None:
                owned = Keys([])   # INSUFFICIENT on device, no registration
            else:
                owned = self.store.owned(body.keys)
        if not isinstance(owned, Keys) or len(owned) > self.kpad:
            return False
        op.owned = owned
        return True

    # -- device flush --------------------------------------------------------

    def _build_device(self) -> None:
        dev = self.device
        self._device = {
            "status": upload(self.status_h, dev),
            "flags": upload(self.flags_h, dev),
            "promised": upload(self.promised_h, dev),
            "accepted": upload(self.accepted_h, dev),
            "execute_at": upload(self.ea_h, dev),
            "durability": upload(self.dur_h, dev),
            "kmax": upload(self.kmax_h, dev),
            "kvalid": upload(self.kvalid_h, dev),
        }
        self.upload_bytes += (self.status_h.nbytes + self.flags_h.nbytes
                              + self.promised_h.nbytes
                              + self.accepted_h.nbytes + self.ea_h.nbytes
                              + self.dur_h.nbytes + self.kmax_h.nbytes
                              + self.kvalid_h.nbytes)
        for name in _LANES:
            self._dirty[name].clear()
        self._kdirty.clear()
        self._device_stale = False

    def _flush(self) -> None:
        from accord_tpu_torch.ops.deltas import flush_lanes
        if self._device is None or self._device_stale:
            self._build_device()
            return

        def account(nbytes: int, _tier: int) -> None:
            self.upload_bytes += nbytes

        # every dirty lane in one flush: one K4 launch per chunk
        d = self._device
        names, specs = [], []
        for name in _LANES:
            rows = self._dirty[name]
            if rows:
                names.append(name)
                specs.append((d[name], sorted(rows), self._shadow_of(name),
                              account))
                rows.clear()
        if self._kdirty:
            kids = sorted(self._kdirty)
            names += ["kmax", "kvalid"]
            specs += [(d["kmax"], kids, self.kmax_h, account),
                      (d["kvalid"], kids, self.kvalid_h, account)]
            self._kdirty.clear()
        for name, lane in zip(names, flush_lanes(specs)):
            d[name] = lane

    # -- recovery scan (kernels.recovery_scan) -------------------------------

    def _flush_touched(self) -> None:
        """Ship the touched column's dirty rows (or rebuild after growth /
        compaction). Only the scan paths pay for this lane -- it stays off
        the repair block and the dispatch flush entirely."""
        if self._touched_dev is None or self._touched_stale \
                or int(self._touched_dev.shape[0]) != self.cap:
            self._touched_dev = upload(self.touched_h, self.device)
            self.upload_bytes += self.touched_h.nbytes
            self._tdirty.clear()
            self._touched_stale = False
        elif self._tdirty:
            from accord_tpu_torch.ops.deltas import flush_lane

            def account(nbytes: int, _tier: int) -> None:
                self.upload_bytes += nbytes

            self._touched_dev = flush_lane(self._touched_dev,
                                           sorted(self._tdirty),
                                           self.touched_h, account)
            self._tdirty.clear()

    def _stalled_mask(self, now_ms: int, stall_ms: int) -> np.ndarray:
        """The scan predicate over the numpy shadows -- bit for bit the
        fold kernels._recovery_scan_body computes on device: status in the
        live band (excludes the INVALIDATED/TRUNCATED terminals above
        APPLIED) and last arena touch at least stall_ms old."""
        st = self.status_h
        live = (st >= CMD_ST_PRE_ACCEPTED) & (st < CMD_ST_APPLIED)
        return live & ((np.int32(now_ms) - self.touched_h)
                       >= np.int32(stall_ms))

    def recovery_scan_host(self, now_ms: float, stall_ms: float) -> list:
        """Recovery-candidate TxnIds, row-ascending: the host twin of the
        device scan and the fallback target for its counted checksum /
        overflow degradations."""
        t0 = time.perf_counter()
        with self._lock:
            rows = np.nonzero(self._stalled_mask(int(now_ms),
                                                 int(stall_ms)))[0]
            out = [self.tid_by_row[r] for r in rows.tolist()]
        self.recovery_scan_host_s += time.perf_counter() - t0
        return out

    def recovery_scan_device(self, now_ms: float, stall_ms: float) -> list:
        """ONE device query answering recovery-candidate selection over the
        arena columns: compacted row list + checksum, host-verified.
        Mismatch or out_cap overflow falls back to recovery_scan_host --
        counted, and bit-identical by construction (the device predicate is
        the same integer fold over the same flushed columns)."""
        from accord_tpu_torch.ops.kernels import (RECOVERY_OUT_TIERS,
                                            frontier_checksum_host,
                                            recovery_scan)
        t0 = time.perf_counter()
        with self._lock:
            if self._rec_tiers is None:
                from accord_tpu_torch.ops.tiers import OutCapTiers
                self._rec_tiers = OutCapTiers(RECOVERY_OUT_TIERS,
                                              RECOVERY_OUT_TIERS[-1] * 2)
            est = self._rec_tiers.estimate(1)
            out_cap = self._rec_tiers.pick(
                est if est is not None else max(1, self.n_rows // 8))
            self._flush()
            self._flush_touched()
            indptr, rows, csum = _DevBuf(recovery_scan(
                self._device["status"], self._touched_dev,
                int(np.int32(int(now_ms))), int(np.int32(int(stall_ms))),
                out_cap=out_cap)).read()
            total = int(indptr[-1])
            self.recovery_scan_dispatches += 1
            if frontier_checksum_host(indptr, rows) \
                    != int(csum) & 0xFFFFFFFF:
                self.recovery_scan_fallbacks += 1
                self.recovery_scan_device_s += time.perf_counter() - t0
                return self.recovery_scan_host(now_ms, stall_ms)
            self._rec_tiers.observe(total, 1)
            if total > out_cap:
                self._rec_tiers.overflowed()
                self.recovery_scan_overflows += 1
                self.recovery_scan_device_s += time.perf_counter() - t0
                return self.recovery_scan_host(now_ms, stall_ms)
            self.recovery_scan_candidates += total
            out = [self.tid_by_row[r] for r in rows[:total].tolist()]
        self.recovery_scan_device_s += time.perf_counter() - t0
        return out

    # -- fused repair (the device-messages megakernel path) ------------------

    def collect_repair(self):
        """Package the shadows' outstanding flush debt -- the deferred
        twin's dirty rows/kids plus any host-residual updates -- as one
        kernels.cmd_repair scatter block (its 18 arguments, on the plane's
        device) to ride the next protocol_tick, instead of standalone
        flush_lane dispatches.

        Returns None when the device arena is not live (a full rebuild is
        pending; nothing to repair in-kernel), the string "clean" when the
        arena is live with nothing dirty (an interleaved flush already
        repaired it), else (block, (rows, kids)). A repair scatters exactly
        what a flush would -- current shadow values -- so it is idempotent
        and can never go stale."""
        with self._lock:
            if self._device is None or self._device_stale:
                return None
            rows = sorted(set().union(*self._dirty.values()))
            kids = sorted(self._kdirty)
            if not rows and not kids:
                return "clean"
            from accord_tpu_torch.ops.deltas import lane_row_tier
            rpad = lane_row_tier(max(1, len(rows)))
            kpad = lane_row_tier(max(1, len(kids)))
            ridx = np.zeros(rpad, np.intp)
            ridx[:len(rows)] = rows
            kidx = np.zeros(kpad, np.intp)
            kidx[:len(kids)] = kids
            rows_idx = np.full(rpad, self.cap, np.int32)   # pad -> drop
            rows_idx[:len(rows)] = rows
            kid_idx = np.full(kpad, self.kcap, np.int32)
            kid_idx[:len(kids)] = kids
            st_v = self.status_h[ridx]
            fl_v = self.flags_h[ridx]
            pr_v = self.promised_h[ridx]
            ab_v = self.accepted_h[ridx]
            ea_v = self.ea_h[ridx]
            du_v = self.dur_h[ridx]
            km_v = self.kmax_h[kidx]
            kv_v = self.kvalid_h[kidx]
            self.upload_bytes += (rows_idx.nbytes + st_v.nbytes + fl_v.nbytes
                                  + pr_v.nbytes + ab_v.nbytes + ea_v.nbytes
                                  + du_v.nbytes + kid_idx.nbytes
                                  + km_v.nbytes + kv_v.nbytes)
            d = self._device
            block = (d["status"], d["flags"], d["promised"], d["accepted"],
                     d["execute_at"], d["durability"], d["kmax"],
                     d["kvalid"], *(upload(a, self.device) for a in (
                         rows_idx, st_v, fl_v, pr_v, ab_v, ea_v, du_v,
                         kid_idx, km_v, kv_v)))
            return block, (rows, kids)

    def adopt_repair(self, outs, meta, spans: int = 0) -> None:
        """Take the repaired device columns (kernels.cmd_repair's outputs
        here; the reference's protocol_tick): the collected
        rows/kids are clean now (diffed out, not cleared, so anything
        dirtied since collect_repair stays dirty) and `spans` deferred twin
        spans retired their flush debt inside the fused program."""
        with self._lock:
            rows, kids = meta
            st, fl, pr, ab, ea, du, km, kv = outs
            self._device = {"status": st, "flags": fl, "promised": pr,
                            "accepted": ab, "execute_at": ea,
                            "durability": du, "kmax": km, "kvalid": kv}
            rs = set(rows)
            for name in _LANES:
                self._dirty[name] -= rs
            self._kdirty -= set(kids)
            self.defer_retired += spans

    # -- evaluation ----------------------------------------------------------

    def eval_batch(self, ops: Sequence[CmdOp]) -> List[CmdResult]:
        """Evaluate ops IN ORDER: admissible spans run as device dispatches,
        inadmissible ops flush the pending span and take the host handler."""
        with self._lock:
            results: List[Optional[CmdResult]] = [None] * len(ops)
            run: List[Tuple[int, CmdOp]] = []
            store_ok = self._store_ok()
            for i, op in enumerate(ops):
                if self._admit(op, store_ok):
                    run.append((i, op))
                else:
                    self._run_device(run, results)
                    run = []
                    self.fallbacks += 1
                    results[i] = self._host_one(op)
                    # a host handler can move the admission floors (reject/
                    # truncation/range max-conflicts) -- re-sample
                    store_ok = self._store_ok()
            self._run_device(run, results)
            return results   # type: ignore[return-value]

    def _run_device(self, run: List[Tuple[int, CmdOp]],
                    results: List[Optional[CmdResult]]) -> None:
        if not run:
            return
        node = self.store.node
        ops = [op for _, op in run]
        rows = [self._row_for(op.txn_id) for op in ops]
        kid_rows = [[self._kid_for(k) for k in op.owned] for op in ops]

        n = len(ops)
        tier = cmd_op_tier(n)
        op_kind = np.zeros(tier, np.int32)
        op_row = np.zeros(tier, np.int32)
        op_txn = np.zeros((tier, 3), np.int32)
        op_bal = np.zeros((tier, 3), np.int32)
        op_exec = np.full((tier, 3), _NEG, np.int32)
        op_keys = np.full((tier, self.kpad), -1, np.int32)
        op_flags = np.zeros(tier, np.int32)
        # intra-batch dependency links: the kernel's loop carries only
        # op-sized state, so a later op on the same row / kid reads its
        # previous writer's slot instead of the arena
        op_prev = np.full(tier, -1, np.int32)
        op_rlast = np.zeros(tier, bool)
        op_kprev = np.full((tier, self.kpad), -1, np.int32)
        op_klast = np.zeros((tier, self.kpad), bool)
        last_row: Dict[int, int] = {}
        last_kid: Dict[int, Tuple[int, int]] = {}
        for j in range(n):
            r = rows[j]
            op_prev[j] = last_row.get(r, -1)
            last_row[r] = j
            for s, kid in enumerate(kid_rows[j]):
                if kid in last_kid:
                    p, ps = last_kid[kid]
                    op_kprev[j, s] = p * self.kpad + ps
                last_kid[kid] = (j, s)
        for j in last_row.values():
            op_rlast[j] = True
        for j, s in last_kid.values():
            op_klast[j, s] = True
        now = int(node.time_service.now_micros())
        op_now = np.full(tier, now, np.int32)
        timeout_us = node.agent.pre_accept_timeout_ms() * 1000.0
        for j, op in enumerate(ops):
            op_kind[j] = op.kind
            op_row[j] = rows[j]
            op_txn[j] = _enc(op.txn_id)
            op_bal[j] = _enc(op.ballot)
            if op.execute_at is not None:
                op_exec[j] = _enc(op.execute_at)
            for s, kid in enumerate(kid_rows[j]):
                op_keys[j, s] = kid
            f = CMD_F_VALID
            if op.ballot == Ballot.ZERO:
                f |= CMD_F_PERMIT_FAST
            if op.txn_id.epoch >= node.epoch:
                f |= CMD_F_EPOCH_OK
            if op.kind == CMD_OP_PREACCEPT \
                    and not op.txn_id.kind.is_sync_point \
                    and now - op.txn_id.hlc >= timeout_us:
                f |= CMD_F_EXPIRED
            if op.txn is not None:
                f |= CMD_F_MSG_HAS_TXN
            if op.deps is None or op.deps.is_empty():
                f |= CMD_F_DEPS_EMPTY
            op_flags[j] = f

        from accord_tpu_torch.ops.kernels import cmd_tick
        t0 = time.perf_counter()
        self._flush()
        d = self._device
        lane2_clean = node.id - _LANE2_OFF
        lane2_rej = ((0x8000 << 16) | node.id) - _LANE2_OFF
        # the op lanes ride two uploads: every int lane in one buffer, the
        # two last-writer masks in another
        ints = upload(np.concatenate([
            a.reshape(-1) for a in (op_kind, op_row, op_txn, op_bal,
                                    op_exec, op_keys, op_flags, op_now,
                                    op_prev, op_kprev)]), self.device)
        bools = upload(np.concatenate([op_rlast, op_klast.reshape(-1)]),
                       self.device)
        kp = self.kpad
        sizes = (tier, tier, 3 * tier, 3 * tier, 3 * tier, kp * tier, tier,
                 tier, tier, kp * tier)
        (t_kind, t_row, t_txn, t_bal, t_exec, t_keys, t_flags, t_now,
         t_prev, t_kprev) = ints.split(sizes)
        out = cmd_tick(
            d["status"], d["flags"], d["promised"], d["accepted"],
            d["execute_at"], d["durability"], d["kmax"], d["kvalid"],
            int(np.int32(node._last_hlc)),
            t_kind, t_row, t_txn.view(tier, 3), t_bal.view(tier, 3),
            t_exec.view(tier, 3), t_keys.view(tier, kp), t_flags, t_now,
            t_prev, bools[:tier], t_kprev.view(tier, kp),
            bools[tier:].view(tier, kp), int(node.epoch), lane2_clean,
            lane2_rej, int(Durability.LOCAL),
            promote=(not self.apply_to_store) or self.authoritative)
        blk = cmd_tick_readback(out)
        c = CMD_ROW_LANES + 4 * kp
        out_code = blk[:tier]
        out_status = blk[tier:2 * tier]
        out_ts = blk[2 * tier:5 * tier].reshape(tier, 3)
        chains = blk[5 * tier:tier * (5 + c)].reshape(tier, c)
        clock = int(blk[-2])
        csum = int(blk[-1]) & 0xFFFFFFFF
        self.flush_s += time.perf_counter() - t0
        if cmd_checksum_host(out_code, out_status, out_ts, clock) != csum:
            # readback integrity lost: do NOT adopt the
            # device result; rebuild from the still-authoritative shadows
            # and answer this span with the host handlers
            self.checksum_mismatches += 1
            self._device_stale = True
            for i, op in zip((i for i, _ in run), ops):
                self.fallbacks += 1
                results[i] = self._host_one(op)
            return

        self._device = dict(zip(
            ("status", "flags", "promised", "accepted", "execute_at",
             "durability", "kmax", "kvalid"), out[:8]))
        self.dispatches += 1
        node._last_hlc = clock

        # shadow sync: the device columns are authoritative for every row /
        # kid this span touched; a row's / kid's last writer's chain holds
        # its new column values, so a later dirty upload cannot regress
        # the arena
        touched = sorted(last_row)
        lw = chains[[last_row[r] for r in touched]]
        self.status_h[touched] = lw[:, 0]
        self.flags_h[touched] = lw[:, 1]
        self.promised_h[touched] = lw[:, 2:5]
        self.accepted_h[touched] = lw[:, 5:8]
        self.ea_h[touched] = lw[:, 8:11]
        self.dur_h[touched] = lw[:, 11]
        for name in _LANES:
            self._dirty[name] -= set(touched)
        tkids = sorted(last_kid)
        if tkids:
            kv = np.asarray([chains[j, CMD_ROW_LANES + 4 * s:
                                    CMD_ROW_LANES + 4 * s + 4]
                             for j, s in (last_kid[k] for k in tkids)])
            self.kmax_h[tkids] = kv[:, :3]
            self.kvalid_h[tkids] = kv[:, 3] != 0
            self._kdirty -= set(tkids)

        # fast-path accounting: a successful preaccept whose witness IS the
        # TxnId took the device fast path (slow/rejected witnesses always
        # carry a bumped hlc or the REJECTED flag lane)
        for j, op in enumerate(ops):
            if op.kind == CMD_OP_PREACCEPT and (int(out_code[j]) & 7) == 0 \
                    and np.array_equal(out_ts[j], op_txn[j]):
                self.fastpath_device_evals += 1

        for (i, op), j in zip(run, range(len(ops))):
            code = int(out_code[j])
            ts = (None if out_ts[j][0] == _NEG
                  else _dec(*(int(x) for x in out_ts[j])))
            if self.apply_to_store:
                self._residual(op, code, ts)
            results[i] = self._result(op, code, ts, int(out_status[j]))

    # -- deferred evaluation (the protocol megakernel) -----------------------

    def defer_batch(self, ops: Sequence[CmdOp],
                    sink=None, fuse=None) -> List[CmdResult]:
        """eval_batch's megakernel twin: decide each admissible PreAccept
        span with the HOST INTEGER TWIN of cmd_tick's PreAccept lane (the
        drain needs the decisions synchronously, before the tick's single
        fused dispatch is assembled) and hand the resulting transition
        lanes to `sink` so they ride protocol_tick's quorum stage. Shadows
        stay authoritative; touched rows mark dirty and the next _flush
        repairs the device columns lazily -- no device dispatch for the
        PreAccept spans, which is the whole point. Admission, ordering, and
        fallback interleaving mirror eval_batch exactly: an admissible
        non-PreAccept op flushes the pending twin span and runs as its own
        DEVICE span (eval_batch would have put it on device, and device vs
        host handlers differ observably for Commit/Apply), an inadmissible
        op flushes and takes the host handler -- so histories are
        bit-identical to the device path for any op mix.

        `fuse` (the device-messages path): called once per nonempty twin
        span with this plane, registering the span's flush debt for
        retirement inside the next protocol_tick via collect_repair()
        instead of a standalone flush_lane dispatch."""
        with self._lock:
            results: List[Optional[CmdResult]] = [None] * len(ops)
            run: List[Tuple[int, CmdOp]] = []
            store_ok = self._store_ok()
            for i, op in enumerate(ops):
                adm = self._admit(op, store_ok)
                if adm and op.kind == CMD_OP_PREACCEPT:
                    run.append((i, op))
                    continue
                self._twin_run(run, results, sink, fuse)
                run = []
                if adm:
                    self._run_device([(i, op)], results)
                else:
                    self.fallbacks += 1
                    results[i] = self._host_one(op)
                    store_ok = self._store_ok()
            self._twin_run(run, results, sink, fuse)
            return results   # type: ignore[return-value]

    def _twin_run(self, run: List[Tuple[int, CmdOp]],
                  results: List[Optional[CmdResult]], sink=None,
                  fuse=None) -> None:
        """Sequential host integer twin of cmd_tick's PreAccept lane over
        one admissible span: same gathers, same predicates, same unique_now
        arithmetic, same writebacks -- executed op by op against the shadow
        columns, so intra-span chains resolve exactly like the kernel's
        prev-writer links (tests/test_megakernel.py runs the differential
        against eval_batch)."""
        if not run:
            return
        node = self.store.node
        ops = [op for _, op in run]
        # _row_for/_kid_for lazily create and seed rows -- same call order
        # as _run_device so allocation histories match bit for bit
        rows = [self._row_for(op.txn_id) for op in ops]
        kid_rows = [[self._kid_for(k) for k in op.owned] for op in ops]
        now = int(node.time_service.now_micros())
        timeout_us = node.agent.pre_accept_timeout_ms() * 1000.0
        node_epoch = int(node.epoch)
        lane2_clean = node.id - _LANE2_OFF
        lane2_rej = ((0x8000 << 16) | node.id) - _LANE2_OFF
        clock = int(node._last_hlc)
        n = len(ops)
        q_txn = np.zeros((n, 3), np.int32)
        q_ts = np.full((n, 3), _NEG, np.int32)
        q_code = np.zeros(n, np.int32)
        out_status = np.zeros(n, np.int32)

        for j, op in enumerate(ops):
            r = rows[j]
            txn = _enc(op.txn_id)
            bal = _enc(op.ballot)
            permit_fast = op.ballot == Ballot.ZERO
            epoch_ok = op.txn_id.epoch >= node_epoch
            expired = (not op.txn_id.kind.is_sync_point
                       and now - op.txn_id.hlc >= timeout_us)
            st = int(self.status_h[r])
            fl = int(self.flags_h[r])
            pr = tuple(int(x) for x in self.promised_h[r])
            ea = tuple(int(x) for x in self.ea_h[r])
            has_txn = (fl & 1) != 0
            ea_set = ea[0] != _NEG
            terminal = st in (CMD_ST_INVALIDATED, CMD_ST_TRUNCATED)
            pr_gt_bal = bal < pr
            term_code = (CMD_OUT_REJECTED_BALLOT
                         if st == CMD_ST_INVALIDATED else CMD_OUT_TRUNCATED)
            mc = None
            for kid in kid_rows[j]:
                if self.kvalid_h[kid]:
                    v = tuple(int(x) for x in self.kmax_h[kid])
                    if mc is None or v > mc:
                        mc = v
            mc_any = mc is not None

            def unow(al_ep, al_hlc, lane2):
                h = max(now, clock + 1)
                if al_hlc >= h:
                    h = al_hlc + 1
                return (max(node_epoch, al_ep), h, lane2), h

            rej_w, rej_h = unow(txn[0], txn[1], lane2_rej)
            al = mc if mc_any else txn
            slow_w, slow_h = unow(al[0], al[1], lane2_clean)
            fast = permit_fast and epoch_ok \
                and (not mc_any or not (txn < mc))
            witness = rej_w if expired else (txn if fast else slow_w)
            wit_clock = rej_h if expired else (clock if fast else slow_h)
            blocked = terminal or pr_gt_bal
            code = (term_code if terminal
                    else CMD_OUT_REJECTED_BALLOT if pr_gt_bal
                    else CMD_OUT_REDUNDANT if has_txn and permit_fast
                    else CMD_OUT_SUCCESS)
            pa_wit = not blocked and not has_txn and not ea_set
            if blocked or has_txn:
                new_st = st
            elif ea_set:
                new_st = max(st, CMD_ST_PRE_ACCEPTED)
            else:
                new_st = CMD_ST_PRE_ACCEPTED
            new_fl = fl if blocked else (fl | 1)
            new_pr = pr if blocked else max(pr, bal)
            new_ea = witness if pa_wit else ea
            if pa_wit:
                clock = wit_clock

            vals = {"status": np.int32(new_st),
                    "flags": np.int32(new_fl),
                    "promised": np.asarray(new_pr, np.int32),
                    "execute_at": np.asarray(new_ea, np.int32)}
            changed = False
            for name, v in vals.items():
                sh = self._shadow_of(name)
                if not np.array_equal(sh[r], v):
                    sh[r] = v
                    self._dirty[name].add(r)
                    changed = True
            if changed:
                self._touch(r)
            if pa_wit:
                w_arr = np.asarray(witness, np.int32)
                for kid in kid_rows[j]:
                    kv = bool(self.kvalid_h[kid])
                    km = tuple(int(x) for x in self.kmax_h[kid])
                    if not kv or km < witness:
                        self.kmax_h[kid] = w_arr
                        self._kdirty.add(kid)
                    if not kv:
                        self.kvalid_h[kid] = True
                        self._kdirty.add(kid)

            q_txn[j] = txn
            q_ts[j] = new_ea
            q_code[j] = code
            out_status[j] = new_st

        node._last_hlc = clock
        self.deferred_spans += 1
        self.deferred_ops += n
        if fuse is not None:
            fuse(self)
        if sink is not None:
            sink(q_txn, q_ts, q_code)
        for (i, op), j in zip(run, range(n)):
            code = int(q_code[j])
            ts = (None if q_ts[j][0] == _NEG
                  else _dec(*(int(x) for x in q_ts[j])))
            if self.apply_to_store:
                self._residual(op, code, ts)
            results[i] = self._result(op, code, ts, int(out_status[j]))

    # -- host paths ----------------------------------------------------------

    def _host_one(self, op: CmdOp) -> CmdResult:
        from accord_tpu_torch.local import commands
        store = self.store
        if op.kind == CMD_OP_PREACCEPT:
            outcome = commands.preaccept(store, op.txn_id, op.txn, op.route,
                                         op.ballot)
        elif op.kind == CMD_OP_ACCEPT:
            outcome = commands.accept(store, op.txn_id, op.ballot, op.route,
                                      op.keys, op.execute_at, op.deps)
        elif op.kind == CMD_OP_COMMIT:
            outcome = commands.commit(store, op.txn_id, op.route, op.txn,
                                      op.execute_at, op.deps)
        else:
            outcome = commands.apply(store, op.txn_id, op.route, op.txn,
                                     op.execute_at, op.deps, op.writes,
                                     op.result)
        cmd = store.command_if_present(op.txn_id)
        st = cmd.status if cmd is not None else Status.NOT_DEFINED
        ea = cmd.execute_at if cmd is not None else None
        return CmdResult(outcome, st, ea, -1)

    def _result(self, op: CmdOp, code: int, ts, status_i: int) -> CmdResult:
        from accord_tpu_torch.local.commands import AcceptOutcome, CommitOutcome
        low = code & 7
        if op.kind in (CMD_OP_PREACCEPT, CMD_OP_ACCEPT):
            outcome = (AcceptOutcome.SUCCESS, AcceptOutcome.REDUNDANT,
                       AcceptOutcome.REJECTED_BALLOT,
                       AcceptOutcome.TRUNCATED)[low]
        else:
            outcome = {0: CommitOutcome.SUCCESS, 1: CommitOutcome.REDUNDANT,
                       4: CommitOutcome.INSUFFICIENT}[low]
        return CmdResult(outcome, Status(status_i), ts, code)

    def _residual(self, op: CmdOp, code: int, ts) -> None:
        """Replay the handler's host-side effects for a device-decided op:
        same mutations as local/commands.py with the decision (witness
        timestamp / outcome / promotion) taken from the kernel output."""
        from accord_tpu_torch.local import commands
        from accord_tpu_torch.local.cfk import CfkStatus
        from accord_tpu_torch.local.commands import (REC, _init_waiting_on,
                                               _is_home, _rec_step,
                                               maybe_execute,
                                               notify_listeners)
        from accord_tpu_torch.primitives.timestamp import Domain
        store = self.store
        low = code & 7
        if op.kind == CMD_OP_PREACCEPT:
            if low in (2, 3):
                return   # rejected/truncated: handler mutates nothing
            cmd = store.command(op.txn_id)
            if cmd.txn is not None:
                cmd.promised = max(cmd.promised, op.ballot)
                return   # REDUNDANT / non-zero-ballot SUCCESS: promise only
            cmd.txn = op.txn
            cmd.route = op.route if cmd.route is None else cmd.route
            cmd.promised = max(cmd.promised, op.ballot)
            if cmd.execute_at is None:
                witnessed = (op.txn_id if ts is not None
                             and ts == op.txn_id.as_timestamp()
                             and not ts.is_rejected else ts)
                cmd.execute_at = witnessed
                cmd.status = Status.PRE_ACCEPTED
                if REC.enabled:
                    _rec_step(store, op.txn_id, "preaccepted")
                store.register(op.txn_id, op.txn.keys, CfkStatus.WITNESSED,
                               witnessed)
                store.progress_log.preaccepted(cmd, _is_home(store, cmd))
            else:
                cmd.status = max(cmd.status, Status.PRE_ACCEPTED)
            notify_listeners(store, cmd)
        elif op.kind == CMD_OP_ACCEPT:
            if low != 0:
                return
            cmd = store.command(op.txn_id)
            cmd.route = op.route if cmd.route is None else cmd.route
            cmd.execute_at = op.execute_at
            cmd.promised = op.ballot
            cmd.accepted_ballot = op.ballot
            if op.deps is not None:
                cmd.deps = op.deps.slice(store.ranges)
                cmd.accepted_scope = op.keys.to_ranges()
            cmd.status = Status.ACCEPTED
            if REC.enabled:
                _rec_step(store, op.txn_id, "accepted")
            store.register(op.txn_id, op.keys, CfkStatus.WITNESSED,
                           op.execute_at)
            store.progress_log.accepted(cmd, _is_home(store, cmd))
            notify_listeners(store, cmd)
        elif op.kind == CMD_OP_COMMIT:
            cmd = store.command_if_present(op.txn_id)
            if low == 1:
                if code & CMD_OUT_INCONSISTENT_BIT and cmd is not None:
                    store.node.agent.on_inconsistent_timestamp(
                        cmd, cmd.execute_at, op.execute_at)
                return
            if low != 0:
                return
            cmd = store.command(op.txn_id)
            if op.txn is not None:
                cmd.txn = op.txn if cmd.txn is None else cmd.txn.union(op.txn)
            cmd.route = op.route if cmd.route is None else cmd.route
            cmd.execute_at = op.execute_at
            cmd.deps = op.deps
            cmd.status = Status.STABLE
            if REC.enabled:
                _rec_step(store, op.txn_id, "stable")
            store.register(op.txn_id, cmd.txn.keys, CfkStatus.COMMITTED,
                           max(op.execute_at, op.txn_id.as_timestamp()),
                           op.execute_at)
            if op.txn_id.kind is TxnKind.WRITE \
                    and op.txn_id.domain is Domain.KEY:
                store.register_commit_cover(op.txn_id, op.execute_at,
                                            op.deps)
            _init_waiting_on(store, cmd)
            if store.exec_plane is not None:
                store.exec_plane.on_stable(cmd)
            store.progress_log.stable(cmd, _is_home(store, cmd))
            store.node.events.on_stable(cmd)
            notify_listeners(store, cmd)
            maybe_execute(store, cmd)
        else:   # apply
            cmd = store.command_if_present(op.txn_id)
            if low == 1:
                if code & CMD_OUT_INCONSISTENT_BIT and cmd is not None:
                    store.node.agent.on_inconsistent_timestamp(
                        cmd, cmd.execute_at, op.execute_at)
                return
            if low != 0:
                return
            cmd = store.command(op.txn_id)
            if op.txn is not None:
                cmd.txn = op.txn if cmd.txn is None else cmd.txn.union(op.txn)
            cmd.route = op.route if cmd.route is None else cmd.route
            was_stable = bool(code & CMD_OUT_WAS_STABLE_BIT)
            cmd.execute_at = op.execute_at
            if not was_stable:
                cmd.deps = op.deps
            cmd.writes = op.writes
            cmd.result = op.result
            cmd.status = Status.PRE_APPLIED
            store.register(op.txn_id, cmd.txn.keys, CfkStatus.COMMITTED,
                           max(op.execute_at, op.txn_id.as_timestamp()),
                           op.execute_at)
            if not was_stable:
                _init_waiting_on(store, cmd)
            if store.exec_plane is not None:
                store.exec_plane.on_stable(cmd)
            store.progress_log.executed(cmd, _is_home(store, cmd))
            notify_listeners(store, cmd)
            maybe_execute(store, cmd)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        return self.metrics.snapshot()

