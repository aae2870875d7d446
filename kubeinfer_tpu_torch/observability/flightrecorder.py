"""Scheduler flight recorder: a bounded ring of admission decisions.

When a slot is retired under chaos, or an admit stalls behind pool
backpressure, the Prometheus counters say *that* it happened but not
*what the scheduler saw* at that moment. The flight recorder keeps the
last N scheduler decisions — submit / admit / retire / evict /
backpressure — each stamped with the queue depth and KV-pool occupancy
observed at decision time, so a post-mortem (``/debug/flightrecorder``,
or the automatic dump when ``_fail_inflight`` releases waiters) replays
the lead-up instead of guessing from aggregates.

Same construction rules as the step profiler: plain ``deque`` ring (no
``os.urandom`` — seeded RNG streams stay untouched), timestamps from
``tracing.now()`` so SimulatedClock tests see one coherent timeline,
bounded memory by capacity.

A copy of ``kubeinfer_tpu/observability/flightrecorder.py`` for the
PyTorch port. Its lock is a plain ``threading.Lock`` (``name`` is kept
for signature parity). The ``set_monitor`` hook is kept, None by
default: the protocol monitor that the reference hangs there lives in
``analysis/``, which the port does not have.
"""

from __future__ import annotations

import collections
import itertools
import threading
from dataclasses import dataclass, field

from kubeinfer_tpu_torch.observability import tracing

__all__ = ["FlightEvent", "FlightRecorder", "set_monitor", "get_monitor"]

# the decision vocabulary; note() rejects anything else so dashboards
# and tests can enumerate the kinds. The transition structure over
# these — which kind may follow which, per request — lives in ONE
# place: analysis/protocol.py SPEC. protolint checks the two stay
# set-equal, so a kind added here without a declared transition (or
# removed here while the spec still names it) fails lint.
KINDS = (
    "submit", "admit", "retire", "evict", "backpressure", "fail_inflight",
    "preempt", "resume", "chunk",
    # per-request terminal failure (stop()/_fail_inflight sweeps name
    # each dropped request; "fail_inflight" stays the aggregate)
    "fail",
    # disaggregated prefill/decode (disagg/): a remote prefix staged
    # for scatter, landed in the pool, or rejected at validation
    "import_staged", "import", "import_reject",
    # live-session migration (drain): the drain window, one streamed
    # chunk, a session handed off, and the sink-failure fall-forward
    "drain_start", "drain_end", "migrate_chunk", "migrate",
    "migrate_sink_error",
)

# Detail-schema hook: when armed (tests/conftest.py for chaos tests,
# schedfuzz's run_scenario), every note() on every recorder is fed to
# the protocol monitor — under the recorder's own lock, so per-recorder
# events arrive in seq order and the oracle never sees a reordering the
# ring itself didn't. The monitor records violations rather than
# raising (a raise here would kill a scheduler thread mid-handoff).
_MONITOR = None

# recorder identity for the monitor's chain keying: two engines in one
# test must not alias request ids
_UIDS = itertools.count()


def set_monitor(monitor) -> None:
    global _MONITOR
    _MONITOR = monitor


def get_monitor():
    return _MONITOR


@dataclass(frozen=True)
class FlightEvent:
    seq: int
    t: float  # tracing-clock seconds
    kind: str
    queue_depth: int  # submit queue + holdover at decision time
    kv_in_use: int  # pool blocks referenced at decision time
    kv_free: int  # pool free-list size at decision time
    detail: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "seq": self.seq, "t": self.t, "kind": self.kind,
            "queue_depth": self.queue_depth, "kv_in_use": self.kv_in_use,
            "kv_free": self.kv_free, "detail": dict(self.detail),
        }

    def render(self) -> str:
        extra = " ".join(f"{k}={v}" for k, v in sorted(self.detail.items()))
        return (
            f"[{self.seq:6d}] t={self.t:.6f} {self.kind:<12} "
            f"queue={self.queue_depth} kv={self.kv_in_use}/"
            f"{self.kv_in_use + self.kv_free}{' ' + extra if extra else ''}"
        )


class FlightRecorder:
    """Fixed-capacity ring of :class:`FlightEvent` (newest win)."""

    def __init__(self, capacity: int = 512,
                 name: str = "observability.FlightRecorder._lock") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._ring: collections.deque[FlightEvent] = collections.deque(
            maxlen=capacity
        )
        self._seq = 0
        self.uid = next(_UIDS)

    def note(self, kind: str, queue_depth: int = 0, kv_in_use: int = -1,
             kv_free: int = -1, t: float | None = None,
             **detail) -> FlightEvent:
        if kind not in KINDS:
            raise ValueError(f"unknown flight-recorder kind {kind!r}")
        t = tracing.now() if t is None else t
        with self._lock:
            ev = FlightEvent(
                seq=self._seq, t=t, kind=kind, queue_depth=queue_depth,
                kv_in_use=kv_in_use, kv_free=kv_free, detail=detail,
            )
            self._seq += 1
            self._ring.append(ev)
            mon = _MONITOR
            if mon is not None:
                mon.observe(self, ev)
        return ev

    def snapshot(self, since_seq: int = -1) -> list[FlightEvent]:
        """Events with ``seq > since_seq`` (all, by default) — the same
        exactly-once cursor contract as ``StepProfiler.snapshot``, so a
        long-run drainer (fleetview, ``/debug/flightrecorder?since=``)
        replays each decision once even though the ring itself keeps
        overwriting. Events already evicted by the ring before the
        drainer came back are gone; ``recorded`` in :meth:`to_dict`
        versus the cursor gap is how a reader detects that loss."""
        with self._lock:
            return [e for e in self._ring if e.seq > since_seq]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def to_dict(self, since_seq: int = -1) -> dict:
        events = self.snapshot(since_seq)
        return {
            "capacity": self._ring.maxlen,
            "recorded": self._seq,
            "events": [e.to_dict() for e in events],
        }

    def render(self) -> str:
        """Human-readable dump, oldest first — what ``_fail_inflight``
        logs so a crashed serving run leaves its last decisions in the
        log stream without anyone having to curl the debug endpoint
        before the process dies."""
        return "\n".join(e.render() for e in self.snapshot())

    def counter_events(self, pid: int) -> list[dict]:
        """Chrome trace-event ``C`` samples: queue-depth and kv-block
        curves from the decision stream, merged next to the span
        timeline (docs/OBSERVABILITY.md)."""
        events: list[dict] = []
        for e in self.snapshot():
            ts = e.t * 1e6
            events.append({
                "ph": "C", "name": "queue_depth", "pid": pid, "tid": 0,
                "ts": ts, "args": {"depth": e.queue_depth},
            })
            if e.kv_in_use >= 0:
                events.append({
                    "ph": "C", "name": "kv_blocks", "pid": pid, "tid": 0,
                    "ts": ts,
                    "args": {"in_use": e.kv_in_use, "free": e.kv_free},
                })
        return events
