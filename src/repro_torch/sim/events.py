"""Minimal deterministic event-driven simulation core (splitwise-sim
style), copied from `repro.sim.events`: a heap with an insertion counter
as the tie-break, so events of equal time fire in the reference's
order."""
from __future__ import annotations

import heapq
import itertools
from typing import Callable


class EventQueue:
    """Time-ordered callback queue. Ties break by insertion order, so the
    simulation is fully deterministic given a seed."""

    def __init__(self):
        self._heap: list = []
        self._counter = itertools.count()
        self.now = 0.0
        self.processed = 0  # events executed (perf observability)

    def schedule(self, time: float, fn: Callable[[], None]) -> None:
        if time < self.now - 1e-12:
            time = self.now  # never schedule into the past
        heapq.heappush(self._heap, (time, next(self._counter), fn))

    def schedule_in(self, delay: float, fn: Callable[[], None]) -> None:
        # Inlined `schedule` (this is the event loop's hottest producer):
        # now + max(delay, 0) can never land in the past.
        heapq.heappush(
            self._heap,
            (self.now + (delay if delay > 0.0 else 0.0),
             next(self._counter), fn))

    def run_until(self, t_end: float) -> None:
        heap = self._heap
        pop = heapq.heappop
        n = 0
        while heap and heap[0][0] <= t_end:
            time, _, fn = pop(heap)
            self.now = time
            fn()
            n += 1
        self.processed += n
        self.now = max(self.now, t_end)

    def __len__(self) -> int:
        return len(self._heap)
