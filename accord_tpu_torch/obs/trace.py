"""FlightRecorder: a bounded ring buffer of trace events.

Disabled (the default) every record call is a single attribute check and
an immediate return -- no allocation, no clock read -- so the recorder can
stay compiled into every hot path. Enabled, events append into a deque
ring (oldest dropped beyond `capacity`, counted in `dropped`).

Timestamps are supplied by callers in MICROSECONDS from the owning node's
time service -- deterministic sim time in the simulator, so two same-seed
runs produce byte-identical event streams. Wall-clock durations are
recorded only when `wall=True` (the bench's trace mode); with it off, the
default, spans carry dur=0 and the stream stays replay-identical.

Event vocabulary (Chrome trace_event phases, exported by obs/export.py):
  X  complete span   (host pipeline stages; dur = wall us when enabled)
  i  instant         (messages, status transitions, delta uploads)
  b/e async span     (device in-flight windows keyed by dispatch id;
                      txn lifecycle keyed by TxnId)
  s/t/f flow         (coordinator -> replica -> device dispatch linking)

The port runs its kernels eagerly, so there is no tracer whose compiled
programs a recorder call could leak into, and no guard against one.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, List, Optional

_TXN_CAT = "txn"
_FLOW_CAT = "txnflow"


class FlightRecorder:
    __slots__ = ("enabled", "wall", "clock", "dropped", "_buf")

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = False
        # include wall-clock durations/args in events (breaks byte-identical
        # replay of same-seed sim traces; the bench opts in)
        self.wall = False
        # () -> int microseconds, used only by callers with no node in scope
        # (deltas.flush_lane); the sim cluster and maelstrom point it at
        # their deterministic clocks
        self.clock: Optional[Callable[[], int]] = None
        self.dropped = 0
        self._buf: deque = deque(maxlen=capacity)

    # -- lifecycle -----------------------------------------------------------
    def configure(self, capacity: Optional[int] = None,
                  wall: Optional[bool] = None) -> None:
        if capacity is not None and capacity != self._buf.maxlen:
            self._buf = deque(self._buf, maxlen=capacity)
        if wall is not None:
            self.wall = wall

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def events(self) -> List[dict]:
        return list(self._buf)

    def __len__(self) -> int:
        return len(self._buf)

    def now_us(self) -> int:
        if self.clock is not None:
            return self.clock()
        return time.monotonic_ns() // 1000

    # -- append funnel -------------------------------------------------------
    def _append(self, ev: dict) -> None:
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._buf.append(ev)

    # -- record API (every method no-ops unless enabled) ---------------------
    def complete(self, pid: int, tid: str, name: str, ts: int,
                 dur: float = 0.0, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
              "dur": dur if self.wall else 0}
        if args:
            ev["args"] = args
        self._append(ev)

    def instant(self, pid: int, tid: str, name: str, ts: int,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name, "ts": ts,
              "s": "t"}
        if args:
            ev["args"] = args
        self._append(ev)

    def async_begin(self, pid: int, tid: str, name: str, span_id: str,
                    ts: int, cat: str = "device", local: bool = False,
                    args: Optional[dict] = None) -> None:
        """local=True scopes the span id to the process (Chrome id2.local):
        device dispatch ids are per-node counters, so five nodes each
        opening window "d0" must not pair up cross-process. Txn spans stay
        global -- their ids (TxnIds) are cluster-unique and their flows
        deliberately cross processes."""
        if not self.enabled:
            return
        ev = {"ph": "b", "pid": pid, "tid": tid, "name": name, "ts": ts,
              "cat": cat}
        ev.update({"id2": {"local": span_id}} if local else {"id": span_id})
        if args:
            ev["args"] = args
        self._append(ev)

    def async_end(self, pid: int, tid: str, name: str, span_id: str,
                  ts: int, cat: str = "device", local: bool = False,
                  args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        ev = {"ph": "e", "pid": pid, "tid": tid, "name": name, "ts": ts,
              "cat": cat}
        ev.update({"id2": {"local": span_id}} if local else {"id": span_id})
        if args:
            ev["args"] = args
        self._append(ev)

    def flow(self, pid: int, tid: str, ph: str, flow_id: str,
             ts: int) -> None:
        """One flow step: ph 's' (start), 't' (step), or 'f' (finish),
        binding to the zero-duration slice emitted at the same (track, ts)."""
        if not self.enabled:
            return
        self._append({"ph": ph, "pid": pid, "tid": tid, "name": "txn",
                      "ts": ts, "cat": _FLOW_CAT, "id": flow_id,
                      **({"bp": "e"} if ph == "f" else {})})

    # -- txn lifecycle helpers (coordinator + replica call sites) ------------
    def txn_begin(self, pid: int, txn_id, ts: int,
                  args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        tid_s = str(txn_id)
        self.async_begin(pid, "txn", "coordinate", tid_s, ts, cat=_TXN_CAT,
                         args=args)
        self.flow(pid, "txn", "s", tid_s, ts)

    def txn_step(self, pid: int, txn_id, name: str, ts: int,
                 args: Optional[dict] = None) -> None:
        """A replica/coordinator status transition: a zero-duration slice
        (so the flow has something to bind to) plus a flow step."""
        if not self.enabled:
            return
        tid_s = str(txn_id)
        ev = {"ph": "X", "pid": pid, "tid": "txn", "name": name, "ts": ts,
              "dur": 0}
        if args:
            ev["args"] = args
        self._append(ev)
        self.flow(pid, "txn", "t", tid_s, ts)

    def txn_end(self, pid: int, txn_id, ts: int,
                args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        tid_s = str(txn_id)
        self.async_end(pid, "txn", "coordinate", tid_s, ts, cat=_TXN_CAT,
                       args=args)
        self.flow(pid, "txn", "f", tid_s, ts)


# The process-global recorder every instrumentation site checks. Hot paths
# read `REC.enabled` (one attribute load) before doing any work.
REC = FlightRecorder()

# Trace process id for cluster-scoped spans (the ClusterTickEngine's
# per-tick megakernel span): node pids are NodeIds >= 1, so 0 is free.
CLUSTER_PID = 0


def recorder() -> FlightRecorder:
    return REC


def node_pid(node) -> int:
    """Trace process id for a Node: its integer NodeId."""
    return int(getattr(node, "id", 0) or 0)


def node_ts(node) -> int:
    """Deterministic event timestamp for a Node: its time service's
    microsecond clock (sim time under the simulator, so same-seed runs
    emit byte-identical streams)."""
    svc = getattr(node, "time_service", None)
    return svc.now_micros() if svc is not None else REC.now_us()
