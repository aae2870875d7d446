"""Clock abstraction: real time for production, simulated time for tests.

The reference has no testable time source — its lease expiry logic calls
time.Now() directly (internal/agent/coordinator/election.go:144-155) and
consequently has zero tests for election/failover (SURVEY.md §4). Every
time-dependent component here (election, reconciler ticks, heartbeats)
takes a ``Clock`` so distributed-correctness tests can drive lease expiry,
split-brain, and failover deterministically (SURVEY.md §7 hard part 6).

A copy of ``kubeinfer_tpu/utils/clock.py`` for the PyTorch port. Its
locks are plain ``threading`` primitives: the reference's race-checker
hooks are no-ops outside an armed analysis run, and the race checker is
not ported.
"""

from __future__ import annotations

import threading
import time as _time


class Clock:
    """Interface: now() seconds, sleep(), and condition-wait support."""

    def now(self) -> float:
        raise NotImplementedError

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def wait(self, event: threading.Event, timeout: float) -> bool:
        """Wait for ``event`` up to ``timeout`` (simulated clocks advance)."""
        raise NotImplementedError


class RealClock(Clock):
    def now(self) -> float:
        return _time.time()

    def sleep(self, seconds: float) -> None:
        _time.sleep(seconds)

    def wait(self, event: threading.Event, timeout: float) -> bool:
        return event.wait(timeout)


class SimulatedClock(Clock):
    """Deterministic manual clock.

    ``sleep`` blocks the calling thread until another thread ``advance``s the
    clock past the wake deadline — so N threads sleeping on a SimulatedClock
    interleave exactly as their deadlines order them, regardless of host
    scheduling. This is what makes 15s-lease-TTL failover tests run in
    milliseconds.
    """

    def __init__(self, start: float = 0.0):
        self._now = start
        self._cond = threading.Condition()

    def now(self) -> float:
        with self._cond:
            return self._now

    def sleep(self, seconds: float) -> None:
        with self._cond:
            deadline = self._now + seconds
            while self._now < deadline:
                self._cond.wait(timeout=1.0)

    def wait(self, event: threading.Event, timeout: float) -> bool:
        # Block on the same condition variable advance() notifies, so waiters
        # wake immediately on clock advancement; a 50ms real-time fallback
        # poll catches event.set() from threads that don't touch the clock.
        with self._cond:
            deadline = self._now + timeout
            while not event.is_set() and self._now < deadline:
                self._cond.wait(timeout=0.05)
        return event.is_set()

    def advance(self, seconds: float) -> None:
        """Advance simulated time, waking any sleepers whose deadline passed."""
        with self._cond:
            self._now += seconds
            self._cond.notify_all()

    def advance_in_steps(self, seconds: float, step: float = 0.5) -> None:
        """Advance in small steps, yielding the GIL so sleeper threads run
        their loop bodies between steps (models real interleaving)."""
        remaining = seconds
        while remaining > 1e-9:
            s = min(step, remaining)
            self.advance(s)
            remaining -= s
            _time.sleep(0.001)
