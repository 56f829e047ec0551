"""Device-plane fault injection + per-node device health state machine.

The protocol plane already burns under injected drops, partitions, crashes,
and topology churn (`utils/faults.py`, `sim/burn.py`); this module gives the
DEVICE plane -- the resolver's dispatch/harvest pipeline -- the same
treatment. A seeded `DeviceFaultPlane` (installed with the same scoped
module-global pattern as `utils/faults.py`) injects four fault kinds at the
dispatch+harvest boundary:

  dispatch_exc  the kernel launch raises (driver/OOM/transfer error);
                the resolver retries a bounded number of times, then
                answers the whole dispatch host-side (degraded).
  stuck         the in-flight call never (or only late) becomes ready;
                the harvest watchdog spends a bounded probe budget, then
                declares the call wedged and answers host-side.
  corrupt       a readback buffer arrives bit-flipped; the checksum lane
                fused into the finalize kernels' returns catches it before
                decode and the group falls back to the legacy decode of
                the (uncorrupted) raw candidate buffers.
  overflow      an out-cap overflow storm: the finalize result reports
                indptr[-1] > out_cap, driving the OutCapTiers policy's
                bump path (and, windowed, proving it bumps once instead
                of oscillating).

Every draw comes from a RandomSource forked from the burn rng, and every
injection is consumed at a deterministic point of the single-threaded sim
event order -- so `--reconcile` determinism holds, and because all four
handling paths deliver their (bit-identical) results at the SAME simulated
harvest event the dispatch would have used, a chaos run's committed history
is bit-identical to the fault-free run of the same seed.

`DeviceHealth` is the per-node degradation ladder the resolver consults:

    HEALTHY --fault--> DEGRADED --more faults--> QUARANTINED
       ^                  |(quiet)                    | (countdown)
       |                  v                           v
       +--canaries ok-- PROBATION <-------------------+
                          |(canary mismatch)
                          +-----> QUARANTINED

Quarantined nodes route every dispatch through the host differential path
(`_Item.fallback == "full"` -> `store.host_calculate_deps`, bit-identical
by the device path's own differential tests); probation re-enters the
device path with canary dispatches whose finalized-CSR decode is checked
against the legacy decode of the same plan-time snapshot, re-using warmed
jit tiers so recovery mints zero recompiles.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

# the four injectable fault kinds, in the (fixed) order draws consume rng
FAULT_KINDS = ("dispatch_exc", "stuck", "corrupt", "overflow")

# module-global active plane, utils/faults.py style: the simulator installs
# one for a run and restores on exit (single-threaded, deterministic)
ACTIVE: Optional["DeviceFaultPlane"] = None


class InjectedDispatchError(RuntimeError):
    """The fault plane's simulated kernel-launch failure."""


class DeviceFaultPlane:
    """Seeded device-fault schedule. One instance per burn run; all nodes'
    resolvers share it, which is deterministic because the sim is
    single-threaded and dispatch/harvest events are totally ordered.

    rates: per-kind injection probability per device dispatch.
    dispatch_exc_burst: max consecutive launch failures per injected
        dispatch fault (drawn uniformly in [1, burst]); a draw above the
        resolver's retry limit exhausts the retries and degrades the
        dispatch, driving the health ladder.
    stuck_probes_max: max not-ready harvest probes an injected stuck call
        eats (drawn in [1, max]); a draw above the resolver's watchdog
        probe budget trips the watchdog (wedged), at or below it the call
        completes late (recovered).
    """

    def __init__(self, rng, *, dispatch_exc_rate: float = 0.0,
                 stuck_rate: float = 0.0, corrupt_rate: float = 0.0,
                 overflow_rate: float = 0.0, mailbox_rate: float = 0.0,
                 dispatch_exc_burst: int = 4, stuck_probes_max: int = 6):
        self.rng = rng
        self.rates: Dict[str, float] = {
            "dispatch_exc": dispatch_exc_rate,
            "stuck": stuck_rate,
            "corrupt": corrupt_rate,
            "overflow": overflow_rate,
            # NOT in FAULT_KINDS / draw(): mailbox corruption is drawn at
            # the message plane's landed-readback point, not per dispatch,
            # so enabling it never shifts the dispatch fault stream of an
            # existing chaos seed
            "mailbox": mailbox_rate,
        }
        self.dispatch_exc_burst = max(1, dispatch_exc_burst)
        self.stuck_probes_max = max(1, stuck_probes_max)
        # injections actually APPLIED (a corrupt draw on a call with no
        # finalized buffer is dropped, not counted), per kind
        self.injected: Dict[str, int] = {k: 0 for k in
                                         FAULT_KINDS + ("mailbox",)}

    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def draw(self) -> Optional[str]:
        """Per-dispatch fault decision, consumed at launch. Fixed kind
        order so the rng stream is schedule-stable."""
        for kind in FAULT_KINDS:
            r = self.rates[kind]
            if r > 0.0 and self.rng.decide(r):
                return kind
        return None

    def draw_burst(self) -> int:
        """Consecutive launch failures for an injected dispatch_exc."""
        return 1 + self.rng.next_int(self.dispatch_exc_burst)

    def draw_stuck(self) -> int:
        """Not-ready probes an injected stuck call eats before readiness."""
        return 1 + self.rng.next_int(self.stuck_probes_max)

    def note(self, kind: str) -> None:
        self.injected[kind] += 1

    def corrupt_arrays(self, bufs) -> bool:
        """Flip one bit of one array in `bufs` (host numpy copies of a
        fetched finalize triple) -- the simulated corrupted readback. The
        flip lands in the arrays the checksum lane covers (never the
        trailing bound/csum words), so every injection is detectable.
        Returns False (and draws nothing) when there is nothing to hit."""
        targets = [b for b in bufs[:3]
                   if isinstance(b, np.ndarray) and b.size > 0]
        if not targets:
            return False
        arr = targets[self.rng.next_int(len(targets))]
        flat = arr.reshape(-1).view(np.uint32)
        pos = self.rng.next_int(int(flat.shape[0]))
        bit = self.rng.next_int(32)
        flat[pos] ^= np.uint32(1) << np.uint32(bit)
        self.note("corrupt")
        return True

    def corrupt_mailbox(self, words: np.ndarray) -> bool:
        """Maybe flip one bit of a landed mailbox message's word lanes (a
        local copy the caller owns) -- the simulated corrupted device
        routing. Drawn at the delivery readback point; the message plane's
        verify-against-staged-bytes contract catches every injection and
        falls back to the host copy, so chaos histories stay bit-identical.
        Draws nothing when the mailbox rate is zero (stream stability)."""
        rate = self.rates.get("mailbox", 0.0)
        if rate <= 0.0 or words.size == 0 or not self.rng.decide(rate):
            return False
        flat = words.reshape(-1).view(np.uint32)
        # flip within the LIVE bytes (payload, else the length header),
        # never the zero padding -- a padding flip would be invisible to
        # the unpack and the injection ledger must match observable
        # verify fallbacks exactly
        nbytes = int(flat[0] & 0x7FFFFFFF)
        as_bytes = words.reshape(-1).view(np.uint8)
        limit = min(nbytes, int(as_bytes.shape[0]) - 4)
        if limit > 0:
            pos = 4 + self.rng.next_int(limit)
        else:
            pos = self.rng.next_int(4)  # empty payload: corrupt the header
        bit = self.rng.next_int(8)
        as_bytes[pos] ^= np.uint8(1) << np.uint8(bit)
        self.note("mailbox")
        return True


class scoped:
    """Install a plane for a with-block, restoring the previous one on
    exit (the utils/faults.py pattern, object-valued)."""

    def __init__(self, plane: Optional[DeviceFaultPlane]):
        self.plane = plane
        self.saved: Optional[DeviceFaultPlane] = None

    def __enter__(self):
        global ACTIVE
        self.saved = ACTIVE
        ACTIVE = self.plane
        return self.plane

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self.saved
        return False


HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
QUARANTINED = "QUARANTINED"
PROBATION = "PROBATION"


class DeviceHealth:
    """Per-node device-path health ladder (see module docstring diagram).

    quarantine_after: consecutive faulted dispatches (from DEGRADED) that
        quarantine the node. recover_after: consecutive clean dispatches
        that walk DEGRADED back to HEALTHY. quarantine_dispatches: host-
        routed dispatches served before probation. probation_canaries:
        consecutive clean canary dispatches that restore HEALTHY.
    on_transition(old, new) fires once per state change (the resolver
    wires it to the obs counters + flight recorder)."""

    __slots__ = ("state", "quarantine_after", "recover_after",
                 "quarantine_dispatches", "probation_canaries",
                 "on_transition", "transitions", "_faults", "_clean",
                 "_host_left", "_canaries_ok")

    def __init__(self, *, quarantine_after: int = 2, recover_after: int = 4,
                 quarantine_dispatches: int = 4, probation_canaries: int = 2,
                 on_transition: Optional[Callable[[str, str], None]] = None):
        self.state = HEALTHY
        self.quarantine_after = max(1, quarantine_after)
        self.recover_after = max(1, recover_after)
        self.quarantine_dispatches = max(1, quarantine_dispatches)
        self.probation_canaries = max(1, probation_canaries)
        self.on_transition = on_transition
        self.transitions = 0
        self._faults = 0      # consecutive faulted dispatches
        self._clean = 0       # consecutive clean dispatches (DEGRADED)
        self._host_left = 0   # quarantine countdown
        self._canaries_ok = 0

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        old, self.state = self.state, state
        self.transitions += 1
        if self.on_transition is not None:
            self.on_transition(old, state)

    @property
    def route_host(self) -> bool:
        """True while every dispatch must answer through the host
        differential path (the quarantine reroute)."""
        return self.state == QUARANTINED

    @property
    def wants_canary(self) -> bool:
        return self.state == PROBATION

    def on_fault(self, kind: str) -> None:
        """A device fault was handled (retry exhausted, watchdog trip,
        checksum mismatch, ...). Escalates HEALTHY -> DEGRADED ->
        QUARANTINED; a probation fault falls straight back."""
        self._clean = 0
        if self.state == QUARANTINED:
            return
        if self.state == PROBATION:
            self.canary_failed()
            return
        self._faults += 1
        if self.state == HEALTHY:
            self._to(DEGRADED)
        if self._faults >= self.quarantine_after:
            self.enter_quarantine()

    def on_clean_dispatch(self) -> None:
        """A device dispatch harvested with no fault. Walks DEGRADED back
        to HEALTHY after recover_after consecutive clean harvests."""
        self._faults = 0
        if self.state == DEGRADED:
            self._clean += 1
            if self._clean >= self.recover_after:
                self._clean = 0
                self._to(HEALTHY)

    def enter_quarantine(self) -> None:
        self._faults = 0
        self._canaries_ok = 0
        self._host_left = self.quarantine_dispatches
        self._to(QUARANTINED)

    def on_host_dispatch(self) -> None:
        """One quarantined dispatch served host-side; after the countdown
        the node re-enters the device path on probation."""
        if self.state != QUARANTINED:
            return
        self._host_left -= 1
        if self._host_left <= 0:
            self._canaries_ok = 0
            self._to(PROBATION)

    def canary_ok(self) -> None:
        if self.state != PROBATION:
            return
        self._canaries_ok += 1
        if self._canaries_ok >= self.probation_canaries:
            self._canaries_ok = 0
            self._to(HEALTHY)

    def canary_failed(self) -> None:
        """A probation canary's device decode diverged from the host
        recompute (or a fault landed during probation): back to
        quarantine for another full countdown."""
        self.enter_quarantine()
