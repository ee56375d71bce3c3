"""Timers and time limits.

Capability parity: ``ortools/base/timer.h:23`` (WallTimer) and
``ortools/util/time_limit.h:44-92`` (TimeLimit with *deterministic time*).

Deterministic time is the reference's mechanism for reproducible parallel
solves: solvers advance a calibrated operation-count-based clock instead of
reading the wall clock.  In this rebuild, deterministic time is naturally
step-count based (device programs are deterministic), but we keep the same
API so portfolio workers can be budgeted reproducibly.
"""

from __future__ import annotations

import math
import time
from typing import Optional


class WallTimer:
    def __init__(self) -> None:
        self._start: Optional[float] = None
        self._elapsed = 0.0
        self._running = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self._running = True

    def stop(self) -> None:
        if self._running and self._start is not None:
            self._elapsed += time.perf_counter() - self._start
        self._running = False

    def restart(self) -> None:
        self._elapsed = 0.0
        self.start()

    def get(self) -> float:
        """Elapsed seconds."""
        if self._running and self._start is not None:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed


class TimeLimit:
    """Wall-clock + deterministic-time + external-interrupt limit.

    ``AdvanceDeterministicTime`` mirrors the reference's dtime counters
    (time_limit.h:63-88): callers report work in calibrated units; a solve
    with ``deterministic_limit`` set stops reproducibly regardless of
    machine speed.
    """

    def __init__(
        self,
        wall_limit_seconds: float = math.inf,
        deterministic_limit: float = math.inf,
    ) -> None:
        self.wall_limit_seconds = wall_limit_seconds
        self.deterministic_limit = deterministic_limit
        self._deterministic_time = 0.0
        self._timer = WallTimer()
        self._timer.start()
        self._interrupted = False

    def interrupt(self) -> None:
        """Cooperative external interruption (reference: sigint.h:21 +
        ``std::atomic<bool>* interrupt_solve``)."""
        self._interrupted = True

    def advance_deterministic_time(self, dtime: float) -> None:
        self._deterministic_time += dtime

    @property
    def deterministic_time(self) -> float:
        return self._deterministic_time

    def elapsed(self) -> float:
        return self._timer.get()

    def remaining(self) -> float:
        return max(0.0, self.wall_limit_seconds - self._timer.get())

    def limit_reached(self) -> bool:
        return (
            self._interrupted
            or self._timer.get() >= self.wall_limit_seconds
            or self._deterministic_time >= self.deterministic_limit
        )
