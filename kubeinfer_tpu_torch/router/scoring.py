"""Replica scoring: one formula shared by the router and the reconciler.

``score = prefix_match_blocks - ALPHA_QUEUE_BLOCKS * queue_pressure``
(minus a flat penalty when the replica's signal is stale). Both terms
are in block units: a prefix hit saves roughly one prefill chunk per
matched block, and queueing behind a saturated replica costs the same
kind of time, so alpha is literally "how many blocks of prefix reuse is
one fully-queued replica worth". Kept deliberately linear — the router
re-scores on every request, so a mis-tuned alpha degrades smoothly
rather than cliffing.

No numpy/jax here: the reconciler imports this module on its tick path
and the router calls it per request; both want plain-int math.

A copy of ``kubeinfer_tpu/router/scoring.py`` for the PyTorch port.
"""

from __future__ import annotations

from typing import Sequence

# How many blocks of prefix reuse one unit of queue pressure (a queue
# as deep as the replica has slots) cancels. At the measured 0.37x
# cold-TTFT ratio a typical 7-block family prefix saves ~4.4 blocks of
# prefill, so a replica a full queue deep must advertise a deeper match
# than that to beat an idle cold one.
ALPHA_QUEUE_BLOCKS = 4.0

# Flat score penalty for replicas whose signal is stale (heartbeat or
# poll older than STALE_AFTER_S): their advertised fingerprints may
# describe an evicted trie, so the claimed match is discounted but the
# replica stays eligible. Past DEAD_AFTER_S the replica leaves the
# candidate set entirely — same TTL the reconciler applies to nodes
# (controller/reconciler.py NODE_HEARTBEAT_TTL_S).
STALE_PENALTY_BLOCKS = 8.0
STALE_AFTER_S = 10.0
DEAD_AFTER_S = 30.0

# Disaggregated prefill cutoff: prompts at least this long take the
# two-phase route (prefill on a prefill-role replica, KV streamed to
# the decode replica) when prefill replicas are configured. Short
# prompts interleave fine — chunked prefill bounds their decode-batch
# stall to one chunk — so shipping their KV would pay the wire cost
# for prefills that were never the head-of-line problem. 256 tokens is
# ~2x the default chunk (4 blocks x 32) — the point where a cold
# prompt starts occupying multiple interleave rounds.
DEFAULT_PREFILL_THRESHOLD_TOKENS = 256

# Reconciler affinity scale: a caching node's pseudo-request match
# depth in the reconciler's route solve is CUTOFF * ALPHA blocks — the
# depth whose score goes negative exactly when queue pressure reaches
# the cutoff. Formerly a binary gate ("affine unless drowning"); now
# the same threshold expressed inside the batched route solve
# (solver/routing.solved_affinity), which makes it relative: a
# drowning caching node keeps its pull against alternatives within
# CUTOFF of its own pressure instead of going cache-blind absolutely.
PRESSURE_AFFINITY_CUTOFF = 1.0


def queue_pressure(serving: dict | None) -> float:
    """Queue depth normalized by slot width, from a servingStats dict
    (engine stats_summary / NodeState.serving_stats). Missing or
    malformed stats read as zero pressure — an empty signal must not
    repel traffic from a replica that simply has not heartbeat yet."""
    if not isinstance(serving, dict):
        return 0.0
    try:
        depth = float(serving.get("queue_depth", 0))
        slots = float(serving.get("n_slots", 0))
    except (TypeError, ValueError):
        return 0.0
    return max(0.0, depth) / max(1.0, slots)


def kv_headroom(serving: dict | None) -> float:
    """Free fraction of the replica's paged-KV pool, from the same
    servingStats dict (``kv_blocks_free`` / ``kv_blocks_in_use``,
    advertised since the pool gauges went real). Missing stats read as
    full headroom — like queue_pressure, an empty signal must not repel
    traffic. Feeds the route solve's gamma plane and, when the router is
    constructed with ``gamma > 0`` (``--headroom-weight``), the
    per-request scorer below; at the default gamma of 0 the scorer stays
    byte-compatible with its pre-headroom behavior."""
    if not isinstance(serving, dict):
        return 1.0
    try:
        free = float(serving.get("kv_blocks_free", 0))
        used = float(serving.get("kv_blocks_in_use", 0))
    except (TypeError, ValueError):
        return 1.0
    total = free + used
    if total <= 0:
        return 1.0
    return max(0.0, free) / total


def match_depth(prefix_fps: Sequence[int], advertised: frozenset | set) -> int:
    """Deepest block prefix of the request present in a replica's
    advertised fingerprint set, in blocks. Scans deepest-first: summary
    truncation can drop an ancestor while keeping a same-stamp deeper
    node, and the deepest membership is the reuse the replica actually
    offers."""
    for i in range(len(prefix_fps) - 1, -1, -1):
        if prefix_fps[i] in advertised:
            return i + 1
    return 0


def replica_score(match_blocks: int, pressure: float, stale: bool,
                  alpha: float = ALPHA_QUEUE_BLOCKS,
                  gamma: float = 0.0, headroom: float = 1.0) -> float:
    """The routing objective for one replica. With zero matches
    everywhere this degenerates to least-loaded — which is exactly the
    documented fallback, not a separate code path.

    ``gamma`` weights KV *fullness* (``1 - headroom``, so a full pool
    repels and an empty one is free) in the same block units as the
    other terms. The defaults (gamma=0, headroom=1) contribute exactly
    ``- 0.0 * 0.0`` — float arithmetic with two literal zeros — so every
    pre-gamma caller gets bit-identical scores; the term mirrors
    solver/routing.py's ``- gamma * (1 - headroom)`` plane so the
    Python and solver engines stay in parity at any weight."""
    s = float(match_blocks) - alpha * pressure - gamma * (1.0 - headroom)
    if stale:
        s -= STALE_PENALTY_BLOCKS
    return s
