"""Minimal Prometheus-compatible collectors + text exposition.

Collector set parity with reference pkg/metrics/metrics.go:27-146 (names
keep the kubeinfer_ prefix so reference dashboards port over), plus the
solver observability the north star adds (solve latency / placement
quality / problem size — SURVEY.md §7 capability targets).

Exposition follows the Prometheus text format (what the reference's secured
/metrics endpoint serves); `Registry.render()` is servable as-is.

A copy of ``kubeinfer_tpu/metrics/registry.py`` for the PyTorch port.
The metric names and labels are the reference's, so its dashboards read
the port's ``/metrics`` unchanged. Its locks are plain ``threading``
primitives: the reference's race-checker hooks are no-ops outside an
armed analysis run, and the race checker is not ported.
"""

from __future__ import annotations

import threading
from typing import Sequence



class Registry:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._collectors: list["_Collector"] = []

    def register(self, c: "_Collector") -> None:
        with self._lock:
            # Prometheus servers reject duplicate metric families; catching
            # the collision at registration time (instead of at scrape time,
            # or never — the old behavior silently rendered both) turns a
            # copy-paste collector name into an immediate, attributable error.
            for existing in self._collectors:
                if existing.name == c.name:
                    raise ValueError(
                        f"collector {c.name!r} already registered"
                    )
            self._collectors.append(c)

    def render(self) -> str:
        """Prometheus text exposition of every registered collector."""
        with self._lock:
            collectors = list(self._collectors)
        return "".join(c.render() for c in collectors)

    def reset(self) -> None:
        """Zero all collectors (test isolation)."""
        with self._lock:
            for c in self._collectors:
                c._reset()


REGISTRY = Registry()


def _escape(v: str) -> str:
    # Prometheus label-value escaping: backslash, double-quote, newline.
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{_escape(v)}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


def _fmt_val(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


class _Collector:
    def __init__(
        self,
        name: str,
        help_: str,
        labels: Sequence[str] = (),
        registry: Registry | None = REGISTRY,
    ):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        if registry is not None:
            registry.register(self)

    def _check(self, label_values: Sequence[str]) -> tuple[str, ...]:
        vals = tuple(str(v) for v in label_values)
        if len(vals) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got {vals}"
            )
        return vals

    def _reset(self) -> None:
        raise NotImplementedError

    def render(self) -> str:
        raise NotImplementedError


class Counter(_Collector):
    TYPE = "counter"

    def __init__(self, name, help_, labels=(), registry=REGISTRY):
        super().__init__(name, help_, labels, registry)
        self._values: dict[tuple[str, ...], float] = {}

    def inc(self, *label_values: str, by: float = 1.0) -> None:
        key = self._check(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + by

    def value(self, *label_values: str) -> float:
        with self._lock:
            return self._values.get(self._check(label_values), 0.0)

    def _reset(self) -> None:
        with self._lock:
            self._values.clear()

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}\n# TYPE {self.name} {self.TYPE}\n"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(
                    f"{self.name}{_fmt_labels(self.label_names, key)} {_fmt_val(v)}\n"
                )
        return "".join(out)


class Gauge(Counter):
    TYPE = "gauge"

    def set(self, *label_values_then_value) -> None:
        *label_values, value = label_values_then_value
        key = self._check(label_values)
        with self._lock:
            self._values[key] = float(value)

    def delete(self, *label_values: str) -> None:
        """Drop a label series (reference DeleteLLMServiceMetrics analogue)."""
        with self._lock:
            self._values.pop(self._check(label_values), None)


class Histogram(_Collector):
    TYPE = "histogram"

    def __init__(self, name, help_, buckets: Sequence[float], labels=(), registry=REGISTRY):
        super().__init__(name, help_, labels, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: dict[tuple[str, ...], list[int]] = {}
        self._sums: dict[tuple[str, ...], float] = {}
        self._totals: dict[tuple[str, ...], int] = {}

    def observe(self, *label_values_then_value) -> None:
        *label_values, value = label_values_then_value
        value = float(value)
        key = self._check(label_values)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            # cumulative le semantics: every bucket with bound >= value
            for k in range(len(self.buckets)):
                if value <= self.buckets[k]:
                    counts[k] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, *label_values: str) -> int:
        with self._lock:
            return self._totals.get(self._check(label_values), 0)

    def sum(self, *label_values: str) -> float:
        with self._lock:
            return self._sums.get(self._check(label_values), 0.0)

    def _reset(self) -> None:
        with self._lock:
            self._counts.clear()
            self._sums.clear()
            self._totals.clear()

    def render(self) -> str:
        out = [f"# HELP {self.name} {self.help}\n# TYPE {self.name} {self.TYPE}\n"]
        with self._lock:
            for key in sorted(self._totals):
                labels = list(zip(self.label_names, key))
                for bound, c in zip(self.buckets, self._counts[key]):
                    le = _fmt_labels(
                        [n for n, _ in labels] + ["le"],
                        [v for _, v in labels] + [_fmt_val(bound)],
                    )
                    out.append(f"{self.name}_bucket{le} {c}\n")
                inf = _fmt_labels(
                    [n for n, _ in labels] + ["le"],
                    [v for _, v in labels] + ["+Inf"],
                )
                out.append(f"{self.name}_bucket{inf} {self._totals[key]}\n")
                lbl = _fmt_labels(self.label_names, key)
                out.append(f"{self.name}_sum{lbl} {_fmt_val(self._sums[key])}\n")
                out.append(f"{self.name}_count{lbl} {self._totals[key]}\n")
        return "".join(out)


# --- reference collector set (metrics.go:27-146) ---------------------------

llmservice_total = Gauge(
    "kubeinfer_llmservice_total",
    "Number of LLMService resources",  # metrics.go:28-33
)
llmservice_ready_replicas = Gauge(
    "kubeinfer_llmservice_ready_replicas",
    "Ready replicas per LLMService",  # metrics.go:47-53
    labels=("namespace", "name"),
)
coordinator_elections_total = Counter(
    "kubeinfer_coordinator_elections_total",
    "Coordinator elections per lease",  # metrics.go:65-71
    labels=("namespace", "lease"),
)
model_download_duration_seconds = Histogram(
    "kubeinfer_model_download_duration_seconds",
    "Model download duration",  # metrics.go:95-102: 10s*2^k, k=0..9
    buckets=[10.0 * 2**k for k in range(10)],
    labels=("source",),  # hub | coordinator
)
reconcile_total = Counter(
    "kubeinfer_reconcile_total",
    "Reconcile outcomes",  # metrics.go:120-126
    labels=("controller", "result"),
)
evacuations_total = Counter(
    "kubeinfer_evacuations_total",
    "SLO-burn evacuations triggered by the reconciler, by node and "
    "outcome (drained = the drainer confirmed; failed = it raised or "
    "declined — the node stays a candidate next tick)",
    labels=("node", "outcome"),
)
reconcile_duration_seconds = Histogram(
    "kubeinfer_reconcile_duration_seconds",
    "Reconcile duration",  # metrics.go:140-146 (DefBuckets)
    buckets=[0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10],
    labels=("controller",),
)

# --- solver observability (new; north-star requirement) --------------------

solve_duration_seconds = Histogram(
    "kubeinfer_solve_duration_seconds",
    "End-to-end scheduler solve latency (encode + device + readback)",
    buckets=[0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5],
    labels=("policy",),
)
solve_placement_ratio = Gauge(
    "kubeinfer_solve_placement_ratio",
    "Fraction of batched replicas placed in the last solve",
    labels=("policy",),
)
solve_problem_size = Gauge(
    "kubeinfer_solve_problem_size",
    "Last solve problem axes",
    labels=("policy", "axis"),  # axis: jobs | nodes
)
auction_fallback_total = Counter(
    "kubeinfer_auction_fallback_total",
    "jax-auction requests rerouted to jax-greedy because the problem is "
    "not a one-replica-per-node instance (auction would silently "
    "under-place)",
)

# --- resilience observability (resilience/) ---------------------------------
# `edge` names a network edge from docs/ARCHITECTURE.md's failure-handling
# catalogue (store, lease, transfer.sync, ...); `point` names a fault
# point (resilience/faultpoints.py). Degradation must be visible on
# /metrics, never silent.

retry_attempts_total = Counter(
    "kubeinfer_retry_attempts_total",
    "Retried attempts per network edge (beyond each call's first try)",
    labels=("edge",),
)
retries_exhausted_total = Counter(
    "kubeinfer_retries_exhausted_total",
    "Calls that failed after exhausting their retry budget",
    labels=("edge",),
)
breaker_transitions_total = Counter(
    "kubeinfer_breaker_transitions_total",
    "Circuit-breaker state transitions",
    labels=("edge", "to"),  # to: closed | open | half-open
)
breaker_state = Gauge(
    "kubeinfer_breaker_state",
    "Circuit-breaker state (0=closed, 1=open, 2=half-open)",
    labels=("edge",),
)
fault_injections_total = Counter(
    "kubeinfer_fault_injections_total",
    "Faults fired by the chaos harness (resilience/faultpoints.py)",
    labels=("point", "mode"),
)
agent_degraded_ticks_total = Counter(
    "kubeinfer_agent_degraded_ticks_total",
    "Node-agent ticks served from last-known bindings during a store outage",
    labels=("node",),
)
agent_store_stale_seconds = Gauge(
    "kubeinfer_agent_store_stale_seconds",
    "Seconds since the node agent last reached the store (0 = fresh)",
    labels=("node",),
)
