"""Simulated Scheduler and TimeService over the shared PendingQueue
(reference: the test Cluster itself implements Scheduler; clock drift per node
comes with the fault-injection milestone)."""
from __future__ import annotations

from typing import Callable

from accord_tpu_torch.api import Scheduler
from accord_tpu_torch.local.node import TimeService
from accord_tpu_torch.sim.queue import Cancellable, PendingQueue


class SimScheduler(Scheduler):
    def __init__(self, queue: PendingQueue):
        self.queue = queue

    def once(self, delay_ms: float, fn: Callable[[], None]) -> Cancellable:
        return self.queue.add(int(delay_ms * 1000), fn)

    def recurring(self, interval_ms: float, fn: Callable[[], None]) -> Cancellable:
        handle = Cancellable()

        def tick():
            if handle.cancelled:
                return
            fn()
            self.queue.add(int(interval_ms * 1000), tick)

        self.queue.add(int(interval_ms * 1000), tick)
        return handle

    def now(self, fn: Callable[[], None]) -> None:
        # run immediately: preserves the reference's semantics of executing on
        # the event loop without further delay, and keeps causal ordering
        fn()

    def poll(self, interval_ms: float, fn: Callable[[], bool]) -> Cancellable:
        """Cheap deterministic poll: re-run `fn` every `interval_ms` of
        simulated time until it returns False (or the handle is cancelled).

        The device pipelines use this to prefetch completed async
        device->host transfers between their dispatch and harvest events
        WITHOUT blocking: `fn` may only mutate host-side caches that are
        invisible to simulated state (the results are delivered at the
        deterministic harvest event either way), so the poll cadence --
        itself a pure function of simulated time -- never perturbs the
        bit-for-bit determinism of a burn."""
        handle = Cancellable()

        def tick():
            if handle.cancelled:
                return
            if fn():
                self.queue.add(int(interval_ms * 1000), tick)

        self.queue.add(int(interval_ms * 1000), tick)
        return handle


class NodeScheduler(SimScheduler):
    """Per-node facade with a kill switch: after a crash, the dead
    incarnation's timers (progress ticks, batch ticks, retries) must neither
    run nor re-arm -- a ghost node scheduling forever would both act on the
    cluster and prevent quiescence.

    The staged tick pipeline (ops/resolver.py) leans on this guard for its
    self-armed launch ticks too: a crashed node's staged (encode-ahead)
    plans and in-flight harvests simply never fire, matching the reference's
    drop-everything crash semantics. Graceful stops instead call
    Node.shutdown(), which drains both pipeline stages through the resolver
    before the scheduler goes quiet."""

    def __init__(self, queue: PendingQueue, alive: list):
        super().__init__(queue)
        self.alive = alive  # single-element cell, flipped False on crash

    def _guard(self, fn: Callable[[], None]) -> Callable[[], None]:
        cell = self.alive

        def run():
            if cell[0]:
                fn()

        return run

    def once(self, delay_ms: float, fn: Callable[[], None]) -> Cancellable:
        return super().once(delay_ms, self._guard(fn))

    def recurring(self, interval_ms: float, fn: Callable[[], None]) -> Cancellable:
        handle = Cancellable()
        cell = self.alive

        def tick():
            if handle.cancelled or not cell[0]:
                return  # dead: neither run nor RE-ARM
            fn()
            self.queue.add(int(interval_ms * 1000), tick)

        self.queue.add(int(interval_ms * 1000), tick)
        return handle

    def poll(self, interval_ms: float, fn: Callable[[], bool]) -> Cancellable:
        handle = Cancellable()
        cell = self.alive

        def tick():
            if handle.cancelled or not cell[0]:
                return  # dead: neither run nor RE-ARM
            if fn():
                self.queue.add(int(interval_ms * 1000), tick)

        self.queue.add(int(interval_ms * 1000), tick)
        return handle

    def now(self, fn: Callable[[], None]) -> None:
        if self.alive[0]:
            fn()


class SimTimeService(TimeService):
    def __init__(self, queue: PendingQueue):
        self.queue = queue

    def now_micros(self) -> int:
        return self.queue.now_micros


class DriftingTimeService(TimeService):
    """Per-node clock with a fixed offset and a frequency error (reference:
    the burn test's per-node clock drift via FrequentLargeRange,
    burn/BurnTest.java:330-340): node time = base * (1 + drift_ppm/1e6)
    + offset. Monotonic because the base queue clock is; HLC uniqueness is
    enforced downstream by Node.unique_now regardless of skew."""

    def __init__(self, queue: PendingQueue, offset_us: int, drift_ppm: int):
        self.queue = queue
        self.offset_us = offset_us
        self.drift_ppm = drift_ppm

    def now_micros(self) -> int:
        base = self.queue.now_micros
        return max(0, base + self.offset_us
                   + (base * self.drift_ppm) // 1_000_000)
