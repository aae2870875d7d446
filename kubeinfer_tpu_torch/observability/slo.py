"""SLO burn-rate monitor over the serving request timelines.

The serving tracing stamps every continuous-batch request with a
timeline (submit/admit/first-token/done), from which TTFT / TPOT /
queue-wait histograms derive. Histograms answer "what is the
distribution"; an operator paging decision needs "how fast are we
burning the error budget" — the multi-window burn-rate construction
from the SRE workbook: for an objective "fraction of requests with
value <= threshold must be >= objective", the burn rate over a window
is

    burn = bad_fraction(window) / (1 - objective)

so burn 1.0 means exactly on budget, 14.4 over 1h is the classic
page-now threshold, and comparing a short and a long window separates
a fresh regression (short >> long) from slow smolder (both elevated).

Implementation rules match the rest of the observability layer: all
timestamps flow through ``tracing.now()`` (SimulatedClock tests assert
exact burn rates), observations land in plain bounded rings (no
``os.urandom``), and the monitor is passive — the server feeds it from
``_observe_breakdown`` and reads gauges at scrape time, so an idle
process pays nothing.

The ring capacity bounds the lookback: with capacity C and request
rate r, windows longer than C/r undercount bad requests *and* total
requests alike, so the burn rate degrades toward the recent-window
value rather than lying in either direction.

A copy of ``kubeinfer_tpu/observability/slo.py`` for the PyTorch port.
Its lock is a plain ``threading.Lock`` (the reference's race-checker
factory is a no-op outside an armed analysis run, and the race checker
is not ported); ``name`` is kept for signature parity.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

from kubeinfer_tpu_torch.observability import tracing

__all__ = ["SLOObjective", "SLOMonitor", "DEFAULT_OBJECTIVES"]


@dataclass(frozen=True)
class SLOObjective:
    """``objective`` of requests must see ``value <= threshold_s``."""

    name: str  # "ttft" | "tpot" | "queue_wait" | custom
    threshold_s: float
    objective: float  # target good fraction, in (0, 1)

    def __post_init__(self) -> None:
        if not (0.0 < self.objective < 1.0):
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        if self.threshold_s <= 0.0:
            raise ValueError(
                f"threshold_s must be > 0, got {self.threshold_s}"
            )

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    @classmethod
    def parse(cls, spec: str) -> "SLOObjective":
        """``name:threshold_s:objective`` (the --slo CLI syntax), e.g.
        ``ttft:0.5:0.99`` = 99% of requests reach first token in
        <= 500 ms."""
        parts = spec.split(":")
        if len(parts) != 3:
            raise ValueError(
                f"SLO spec {spec!r} is not name:threshold_s:objective"
            )
        return cls(parts[0], float(parts[1]), float(parts[2]))


# Deliberately loose defaults (tiny CPU-mesh test engines must not sit
# permanently in violation); production deployments pass their own via
# --slo / InferenceServer(slo=...).
DEFAULT_OBJECTIVES = (
    SLOObjective("ttft", 2.0, 0.99),
    SLOObjective("tpot", 0.5, 0.99),
    SLOObjective("queue_wait", 1.0, 0.99),
)


class SLOMonitor:
    """Multi-window burn rates over per-request latency observations."""

    def __init__(self, objectives=DEFAULT_OBJECTIVES,
                 windows: tuple[float, ...] = (60.0, 300.0, 1800.0),
                 capacity: int = 8192,
                 name: str = "observability.SLOMonitor._lock") -> None:
        if not windows:
            raise ValueError("at least one window is required")
        self.objectives: dict[str, SLOObjective] = {
            o.name: o for o in objectives
        }
        self.windows = tuple(sorted(float(w) for w in windows))
        self.name = name
        self._lock = threading.Lock()
        self._obs: dict[str, collections.deque] = {
            n: collections.deque(maxlen=capacity) for n in self.objectives
        }

    def observe(self, name: str, value_s: float,
                t: float | None = None) -> None:
        """Record one request's value for objective ``name``; unknown
        names are dropped (the server observes every breakdown metric
        unconditionally — which ones carry an SLO is configuration)."""
        ring = self._obs.get(name)
        if ring is None:
            return
        t = tracing.now() if t is None else t
        with self._lock:
            ring.append((t, value_s))

    def _window_counts(self, name: str, now: float) -> dict[float, tuple]:
        obj = self.objectives[name]
        with self._lock:
            obs = list(self._obs[name])
        out = {}
        for w in self.windows:
            inside = [(t, v) for t, v in obs if t >= now - w]
            bad = sum(1 for _, v in inside if v > obj.threshold_s)
            out[w] = (bad, len(inside))
        return out

    def burn_rates(self, now: float | None = None) -> dict:
        """{objective name: {window seconds: burn rate}}. An empty
        window burns 0 (no traffic spends no budget)."""
        now = tracing.now() if now is None else now
        rates: dict[str, dict[float, float]] = {}
        for name, obj in self.objectives.items():
            counts = self._window_counts(name, now)
            rates[name] = {
                w: (bad / total) / obj.budget if total else 0.0
                for w, (bad, total) in counts.items()
            }
        return rates

    def budget_remaining(self, now: float | None = None) -> dict:
        """{objective name: remaining budget fraction over the LONGEST
        window}: 1.0 = untouched, 0.0 = exactly spent, negative =
        overrun (kept signed so dashboards show how far over)."""
        now = tracing.now() if now is None else now
        longest = self.windows[-1]
        out = {}
        for name, obj in self.objectives.items():
            bad, total = self._window_counts(name, now)[longest]
            frac = (bad / total) if total else 0.0
            out[name] = 1.0 - frac / obj.budget
        return out

    def snapshot(self, now: float | None = None) -> dict:
        """/debug/slo payload: objectives, per-window counts and burn
        rates, remaining budget — everything the gauges summarize, with
        the raw counts for auditability."""
        now = tracing.now() if now is None else now
        remaining = self.budget_remaining(now)
        doc: dict = {"now": now, "windows": list(self.windows),
                     "objectives": {}}
        for name, obj in self.objectives.items():
            counts = self._window_counts(name, now)
            doc["objectives"][name] = {
                "threshold_s": obj.threshold_s,
                "objective": obj.objective,
                "budget": obj.budget,
                "windows": {
                    str(int(w)): {
                        "bad": bad,
                        "total": total,
                        "burn_rate": (
                            (bad / total) / obj.budget if total else 0.0
                        ),
                    }
                    for w, (bad, total) in counts.items()
                },
                "budget_remaining": remaining[name],
            }
        return doc
