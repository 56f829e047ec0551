"""Shared padded-size ladders and the out-cap hysteresis policy.

Every jit boundary in the data plane pads its data-dependent dimension to
a small named ladder (batch tiers, CSR nnz tiers, finalized-CSR out tiers,
lane-delta row tiers) so warmup() can pre-compile every shape the pipeline
will ever dispatch. `snap` is that ladder lookup written once -- kernels,
deltas, and the exec plane all route through it, so a new tier cannot
appear in one caller without the others (and warmup) seeing it.

`OutCapTiers` is the piece that makes the FINALIZE kernels warmable: their
out_cap used to be sized from an exact per-dispatch host popcount bound,
which (a) cost a host O(keys) pass per dispatch and (b) made the picked
tier data-dependent, so the bench had to exempt finalize kernels from its
zero-recompile assertion. The policy instead pins a tier with
grow-immediately / shrink-after-hysteresis dynamics, fed by the DEVICE
computed bound that rides back with each finalize result:

  * grow: a bound estimate above the pinned tier switches up immediately
    (correctness -- an undersized out_cap overflows and forces a host
    fallback decode);
  * shrink: only after `shrink_after` consecutive dispatches whose
    estimate fits a smaller tier (stability -- one quiet dispatch in a
    contended run must not flap the jit cache);
  * overflow: an observed `indptr[-1] > out_cap` bumps to the next rung
    right away, so at most one dispatch pays the fallback.

Estimates are WINDOWED: each dispatch's device bound lands in a rolling
window of the last `window` observations, and the estimate projects the
window's HIGH-WATER per-slot ratio onto the current slot count (plus
`headroom`, a >>3 fractional pad floored at `headroom_min`, absorbing the
staleness of riding one in-flight window behind the truth). High-water --
not last-value -- is what keeps bursty mixes stable: one overflow storm
bumps the tier once, and the storm's bound then holds the estimate up for
a full window, so quiet dispatches in between cannot oscillate the pinned
tier back down and re-trip the overflow (shrink hysteresis still applies
on top, after `shrink_after` consecutive below-tier estimates).
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Optional, Tuple


def snap(n: int, tiers: Tuple[int, ...], floor: int) -> int:
    """Smallest named tier >= n; above the ladder, the next power-of-two
    bucket >= max(n, floor) (so oversized shapes stay warmable too)."""
    for tier in tiers:
        if n <= tier:
            return tier
    size = floor
    while size < n:
        size *= 2
    return size


# PreAccept quorum-lane ladder for the protocol megakernel
# (kernels.protocol_tick): one cluster tick's deferred cmd-plane spans stack
# into a single lane block for the fast-path electorate count, padded here
# so lane-count churn between ticks re-lands on compiled signatures.
MEGA_LANE_TIERS = (64, 256, 1024)


def mega_lane_tier(n: int) -> int:
    """Padded PreAccept quorum-lane count for one megakernel cluster tick."""
    return snap(n, MEGA_LANE_TIERS, 4096)


class OutCapTiers:
    """Hysteresis-pinned out_cap tier picker for the finalize kernels.

    One instance per (arena, finalize lane): the per-slot mean bound is a
    property of that arena's contention, not of the resolver globally.
    `on_switch` fires once per pinned-tier change (wired to the resolver's
    `outcap_tier_switches` counter).
    """

    __slots__ = ("tiers", "floor", "shrink_after", "headroom_shift",
                 "headroom_min", "on_switch", "current", "switches",
                 "_window", "_below")

    def __init__(self, tiers: Tuple[int, ...], floor: int,
                 shrink_after: int = 6, headroom_shift: int = 3,
                 headroom_min: int = 64, window: int = 16,
                 on_switch: Optional[Callable[[], None]] = None):
        self.tiers = tiers
        self.floor = floor
        self.shrink_after = shrink_after
        self.headroom_shift = headroom_shift
        self.headroom_min = headroom_min
        self.on_switch = on_switch
        self.current: Optional[int] = None
        self.switches = 0
        # rolling (bound, slots) observations; estimates project the
        # window's high-water per-slot ratio, so a burst's bound keeps the
        # estimate (and the pinned tier) up for `window` dispatches
        self._window: "deque[Tuple[int, int]]" = deque(maxlen=max(1, window))
        self._below = 0

    @property
    def cold(self) -> bool:
        """True until the first device bound has been observed -- the one
        dispatch where the caller must seed with its host-exact bound."""
        return not self._window

    def observe(self, bound: int, slots: int) -> None:
        """Record a dispatch's (device-computed) bound over `slots` CSR
        slots into the rolling window."""
        self._window.append((int(bound), max(int(slots), 1)))

    def estimate(self, slots: int) -> Optional[int]:
        """Projected bound for a dispatch of `slots` slots: the window
        high-water of each observation's per-slot ratio scaled to `slots`,
        plus headroom; None while cold (no observation to scale)."""
        if not self._window:
            return None
        s = max(int(slots), 1)
        base = max((num * s + den - 1) // den for num, den in self._window)
        pad = max(base >> self.headroom_shift, self.headroom_min)
        return base + pad

    def pick(self, bound: int) -> int:
        """Pin and return the out_cap tier for a dispatch whose bound
        estimate is `bound` (grow now, shrink after hysteresis)."""
        want = snap(max(int(bound), 1), self.tiers, self.floor)
        cur = self.current
        if cur is None:
            self.current = want
        elif want > cur:
            self._switch(want)
        elif want < cur:
            self._below += 1
            if self._below >= self.shrink_after:
                self._switch(want)
        else:
            self._below = 0
        return self.current

    def overflowed(self) -> int:
        """The pinned tier overflowed (indptr[-1] > out_cap): bump to the
        next rung immediately and return it."""
        cur = self.current if self.current is not None else self.floor
        self._switch(snap(cur + 1, self.tiers, self.floor))
        return self.current

    def _switch(self, tier: int) -> None:
        self.current = tier
        self._below = 0
        self.switches += 1
        if self.on_switch is not None:
            self.on_switch()
