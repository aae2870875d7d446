"""Prometheus-style metrics (parity: reference pkg/metrics/metrics.go).

The reference registers six collectors but only wires two
(metrics.go:27-147; SURVEY.md §2 #10 "the other four collectors/helpers are
dead wiring"). Here every collector is recorded by the component that owns
it, plus the new solver metrics the north star requires (per-solve latency,
placement quality).

A copy of ``kubeinfer_tpu/metrics/__init__.py`` for the PyTorch port.
"""

from kubeinfer_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
    REGISTRY,
    agent_degraded_ticks_total,
    agent_store_stale_seconds,
    auction_fallback_total,
    breaker_state,
    breaker_transitions_total,
    coordinator_elections_total,
    evacuations_total,
    fault_injections_total,
    llmservice_ready_replicas,
    llmservice_total,
    model_download_duration_seconds,
    reconcile_duration_seconds,
    reconcile_total,
    retries_exhausted_total,
    retry_attempts_total,
    solve_duration_seconds,
    solve_placement_ratio,
    solve_problem_size,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "REGISTRY",
    "agent_degraded_ticks_total",
    "agent_store_stale_seconds",
    "auction_fallback_total",
    "breaker_state",
    "breaker_transitions_total",
    "coordinator_elections_total",
    "evacuations_total",
    "fault_injections_total",
    "llmservice_ready_replicas",
    "llmservice_total",
    "model_download_duration_seconds",
    "reconcile_duration_seconds",
    "reconcile_total",
    "retries_exhausted_total",
    "retry_attempts_total",
    "solve_duration_seconds",
    "solve_placement_ratio",
    "solve_problem_size",
]
