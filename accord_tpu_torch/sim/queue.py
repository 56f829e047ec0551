"""The single logical clock driving a simulated cluster.

Role-equivalent to the reference's RandomDelayQueue + PropagatingPendingQueue
(test impl/basic/RandomDelayQueue.java): a priority queue of (time, seq, fn)
events; seq breaks ties so execution order is fully deterministic.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, List, Optional, Tuple


class Cancellable:
    __slots__ = ("cancelled",)

    def __init__(self):
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def __lt__(self, other) -> bool:
        # heap entries tie-break on (time, seq) alone; ticketed re-arms
        # (add_ticketed_at) can legitimately coexist with a cancelled twin
        # at the same (time, seq), so Cancellables must compare (as equal)
        # instead of raising
        return False


class PendingQueue:
    def __init__(self, start_micros: int = 1_000_000):
        self._heap: List[Tuple[int, int, Cancellable, Callable[[], None]]] = []
        self._seq = itertools.count()
        self.now_micros = start_micros

    def add(self, delay_micros: int, fn: Callable[[], None]) -> Cancellable:
        assert delay_micros >= 0
        handle = Cancellable()
        heapq.heappush(self._heap, (self.now_micros + int(delay_micros),
                                    next(self._seq), handle, fn))
        return handle

    def add_at(self, at_micros: int, fn: Callable[[], None]) -> Cancellable:
        return self.add(max(0, at_micros - self.now_micros), fn)

    # -- ticketed events (the device message plane's exact-order seam) -------
    #
    # The batched delivery drain (sim/network.DeviceMessageNetwork) must
    # occupy EXACTLY the heap position the baseline's per-message deliver
    # event would have: it consumes a ticket from the shared seq stream at
    # the same call site the baseline calls add(), holds the message in a
    # side structure, and parks ONE cursor event back into the heap under
    # the head message's own (time, ticket). Same seq consumption, same
    # total order -- bit-identical schedules by construction.

    def ticket(self) -> int:
        """Consume and return the next event sequence number WITHOUT
        scheduling anything (the caller owns its heap position)."""
        return next(self._seq)

    def add_ticketed_at(self, at_micros: int, ticket: int,
                        fn: Callable[[], None]) -> Cancellable:
        """Schedule `fn` at an absolute time under a previously consumed
        ticket: the event sorts exactly where add() would have placed an
        event created when the ticket was taken."""
        handle = Cancellable()
        heapq.heappush(self._heap, (int(at_micros), int(ticket), handle, fn))
        return handle

    def peek(self) -> Optional[Tuple[int, int]]:
        """(time, seq) of the next live event, or None when drained.
        Lazily discards cancelled heads so a cancelled timeout can never
        masquerade as the earliest event."""
        while self._heap and self._heap[0][2].cancelled:
            heapq.heappop(self._heap)
        if not self._heap:
            return None
        return (self._heap[0][0], self._heap[0][1])

    def is_empty(self) -> bool:
        return not self._heap

    def __len__(self) -> int:
        return len(self._heap)

    def process_one(self) -> bool:
        """Pop and run the next event; returns False when drained."""
        while self._heap:
            at, _, handle, fn = heapq.heappop(self._heap)
            if handle.cancelled:
                continue
            self.now_micros = max(self.now_micros, at)
            fn()
            return True
        return False

    def process_until(self, deadline_micros: int) -> None:
        while self._heap and self._heap[0][0] <= deadline_micros:
            if not self.process_one():
                break
        self.now_micros = max(self.now_micros, deadline_micros)

    def drain(self, max_events: Optional[int] = None) -> int:
        n = 0
        while self.process_one():
            n += 1
            if max_events is not None and n >= max_events:
                break
        return n
