"""Prefix-cache-aware fleet router: the request-path tier.

The reference operator stops at placement — its controller creates pods
and copies ready counts (llmservice_controller.go:66-174) but never
touches a request; clients are assumed to sit behind a dumb Service VIP.
At fleet scale that throws away the single largest serving win this
repo has measured: a radix prefix hit cuts TTFT to ~0.37x cold
(docs/PROFILING.md Round 7), and which replica a request lands on
decides whether that hit exists. Routing IS the cache policy — the
same insight behind SGLang's cache-aware router and Mooncake's
KVCache-centric scheduling.

This package is an HTTP front door over N inference servers:

- Each replica advertises a capped, versioned set of rolling-hash path
  fingerprints (``RadixCache.summary()``) plus its queue signal, via
  ``GET /cache/summary`` directly or via the node-agent heartbeat's
  ``servingStats`` in the control-plane store.
- ``FleetRouter.route`` scores each live replica as
  ``prefix_match_blocks - alpha * queue_pressure`` (scoring.py), with a
  stale-heartbeat penalty; no positive match degrades to least-loaded.
- ``RouterServer`` proxies ``POST /v1/completions`` to the winner under
  a per-replica RetryPolicy + CircuitBreaker, re-scoring onto the next
  replica when a transport fails — a dead replica degrades routing,
  never correctness (completions are a deterministic function of
  (prompt, seed, sampling), so any replica serves the same tokens).

The same (prefix-affinity, queue-pressure) pair feeds the reconciler's
placement cost (controller/reconciler.py), so the control plane and
the data plane optimize one objective.

A copy of ``kubeinfer_tpu/router/__init__.py`` for the PyTorch port:
``core``, ``server`` and ``scoring`` are copies of the reference's
modules of the same names. The batched route solve of ``route_batch``
runs on the router's device (``FleetRouter(device=...)``, the CUDA card
unless named), through ``solver/routing.py`` and kernel #8
(``solver/csrc/route_pick.cu``).
"""

from kubeinfer_tpu_torch.router.core import (
    FleetRouter,
    NoReplicaError,
    ReplicaView,
    RouteDecision,
)
from kubeinfer_tpu_torch.router import scoring
from kubeinfer_tpu_torch.router.server import RouterServer

__all__ = [
    "FleetRouter",
    "NoReplicaError",
    "ReplicaView",
    "RouteDecision",
    "RouterServer",
    "scoring",
]
