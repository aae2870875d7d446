"""Routing brain: replica views, scoring, and the route decision.

State model (SGLang-router style, approximate-then-correct): the router
keeps a LOCAL view of every replica's radix cache — refreshed
authoritatively from ``/cache/summary`` polls or store ``NodeState``
heartbeats, and extended OPTIMISTICALLY after each routed request (the
blocks this request just prefilled will be in that replica's trie well
before the next refresh). Optimism can only overstate a match, and an
overstated match costs one cold prefill on the replica that was going
to serve the request anyway — so the view is allowed to be wrong in
exactly the direction that is cheap.

Transport lives in router.server; nothing here opens a socket, which is
what lets unit tests and the reconciler share this logic verbatim.

A copy of ``kubeinfer_tpu/router/core.py`` for the PyTorch port. Its
lock is a plain ``threading.Lock``: the reference's race-checker hooks
are no-ops outside an armed analysis run, and the race checker is not
ported. Three differences:

- ``FleetRouter(..., device=None)`` resolves the device of its batched
  route solve at construction: ``None`` means the CUDA card and raises
  without one; tests pass ``device="cpu"``.
- The route solver (``solver/routing.py``) imports only torch, so
  ``engine="auto"`` is always the solver. The ``"python"`` engine stays
  as the equivalence oracle, taken only when it is named; no failure of
  the solver falls back to it.
- ``route_batch`` has no ``accel``: the device decides, as in
  ``solve_routes``. ``pack_route_arrays(..., device=self.device)`` puts
  the planes there, and the pick is ``kernels.route_pick``'s CUDA kernel
  on the card and its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.kv_blocks import (
    SUMMARY_FINGERPRINT_BUDGET,
    prefix_fingerprints,
)
from kubeinfer_tpu_torch.metrics.registry import Counter, Gauge, Histogram, Registry
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.resilience import CircuitBreaker, faultpoints
from kubeinfer_tpu_torch.router import scoring
from kubeinfer_tpu_torch.solver import routing as _routing

_TRACER = tracing.get_tracer("router")

# Optimistic inserts are uncapped growth if a replica never confirms
# them; past this the view stops absorbing guesses until the next
# authoritative refresh resets the set.
_OPTIMISTIC_CAP = 4 * SUMMARY_FINGERPRINT_BUDGET


class NoReplicaError(RuntimeError):
    """Every known replica is dead, breaker-open, or excluded."""


def _router_metrics(registry: Registry) -> dict:
    """Per-router collector set (one Registry per router instance, same
    pattern as the inference server's _serving_metrics — module-level
    collectors would cross-pollute multi-router tests and bench)."""
    return {
        "requests": Counter(
            "kubeinfer_router_requests_total",
            "Requests proxied, by upstream replica and outcome",
            labels=("replica", "outcome"), registry=registry,
        ),
        "routed": Counter(
            "kubeinfer_router_routed_total",
            "Routing decisions, by chosen replica and reason "
            "(affinity = positive prefix match; fallback = least-loaded)",
            labels=("replica", "reason"), registry=registry,
        ),
        "affinity_hits": Counter(
            "kubeinfer_router_affinity_hits_total",
            "Decisions where the chosen replica advertised a prefix match",
            registry=registry,
        ),
        "affinity_misses": Counter(
            "kubeinfer_router_affinity_misses_total",
            "Decisions that fell back to least-loaded (no match anywhere)",
            registry=registry,
        ),
        "affinity_ratio": Gauge(
            "kubeinfer_router_affinity_hit_ratio",
            "affinity_hits / decisions since start",
            registry=registry,
        ),
        "skipped": Counter(
            "kubeinfer_router_replicas_skipped_total",
            "Replicas excluded from a decision's candidate set "
            "(breaker = circuit open; dead = signal older than the TTL; "
            "failed = transport failure earlier in this same request; "
            "draining = replica advertised drain, migrating its "
            "sessions out)",
            labels=("replica", "reason"), registry=registry,
        ),
        "replicas": Gauge(
            "kubeinfer_router_replicas",
            "Known replicas by liveness at the last decision",
            labels=("state",), registry=registry,
        ),
        # disaggregated prefill (second routing axis): prefill-role
        # replicas never join the decode candidate set above — their
        # decisions get their own counter so the prefill plane is
        # observable separately from completion placement
        "prefill_routed": Counter(
            "kubeinfer_router_prefill_routed_total",
            "Prefill-phase placements, by chosen prefill replica",
            labels=("replica",), registry=registry,
        ),
        # same metric name as the inference server's fallback counter —
        # different registry, same dashboard query: wherever the
        # degradation happens (router can't reach the prefill tier,
        # decode replica can't pull the blocks), the series reads as
        # one family
        "disagg_fallbacks": Counter(
            "kubeinfer_disagg_fallbacks_total",
            "Two-phase requests that degraded to single-phase routing "
            "(interleaved local prefill), by reason",
            labels=("reason",), registry=registry,
        ),
        # live-session migration (drain/evacuate/rebalance): a source
        # replica parks a mid-flight generation and the router resumes
        # it elsewhere with the tokens-so-far (kubeinfer_resume)
        "migration_resumes": Counter(
            "kubeinfer_router_migration_resumes_total",
            "Migrated sessions resumed on a new replica, by target",
            labels=("replica",), registry=registry,
        ),
        # shares the inference server's metric name for the same
        # one-family dashboard reason as disagg_fallbacks above
        "migration_fallbacks": Counter(
            "kubeinfer_migration_fallbacks_total",
            "Migration hand-offs that degraded at the router, by reason "
            "(no_target = every other replica dead/draining; hop_limit "
            "= rolling drains exceeded the per-request resume budget)",
            labels=("reason",), registry=registry,
        ),
        # batched route solve (storm mode): whole arrival batches
        # assigned in one solver dispatch instead of N Python scans
        "solve_seconds": Histogram(
            "kubeinfer_router_solve_seconds",
            "Batched route-solve latency, snapshot to assignments "
            "(plane build + solve + decision decode)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 1.0, 5.0),
            registry=registry,
        ),
        "batch_size": Gauge(
            "kubeinfer_router_batch_size",
            "Requests assigned by the most recent batched route solve",
            registry=registry,
        ),
        "solver_routed": Counter(
            "kubeinfer_router_solver_routed_total",
            "Requests routed through the batched solve, by mode "
            "(parity/greedy/auction = solver engine; python = the "
            "per-request scorer run in batch form)",
            labels=("mode",), registry=registry,
        ),
        # tokenizer satellite: string prompts that could not be
        # tokenized route as counted least-loaded fallbacks
        "tokenizer_fallback": Counter(
            "kubeinfer_router_tokenizer_fallback_total",
            "String prompts routed without token ids (no tokenizer "
            "configured, or encode failed)",
            registry=registry,
        ),
    }


@dataclass
class ReplicaView:
    """What the router believes about one replica."""

    name: str
    url: str
    fingerprints: set = field(default_factory=set)
    version: int = -1
    block_size: int = 0
    serving: dict = field(default_factory=dict)
    last_seen: float = float("-inf")  # router-clock time of last signal
    breaker: CircuitBreaker | None = None


@dataclass(frozen=True)
class RouteDecision:
    replica: str
    url: str
    match_blocks: int
    match_tokens: int
    pressure: float
    score: float
    stale: bool
    fallback: bool  # no replica had a positive match
    candidates: int  # how many replicas were scored


class FleetRouter:
    """Scores replicas for each request; owns the replica views."""

    def __init__(
        self,
        alpha: float = scoring.ALPHA_QUEUE_BLOCKS,
        stale_after_s: float = scoring.STALE_AFTER_S,
        dead_after_s: float = scoring.DEAD_AFTER_S,
        breaker_threshold: int = 3,
        breaker_reset_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
        registry: Registry | None = None,
        gamma: float = 0.0,
        device=None,
    ) -> None:
        # gamma weights KV fullness (1 - headroom) in every scorer this
        # router runs — per-request, python batch, and the solver's
        # headroom plane alike, so the three engines stay in parity at
        # any weight. Default 0 keeps routing byte-identical to the
        # pre-headroom router (which packed the plane but gave it no
        # weight); RouterServer exposes it as --headroom-weight.
        self.alpha = alpha
        self.gamma = gamma
        # where the batched route solve runs: the card unless named
        self.device = resolve_device(device)
        self.stale_after_s = stale_after_s
        self.dead_after_s = dead_after_s
        self._breaker_threshold = breaker_threshold
        self._breaker_reset_s = breaker_reset_s
        self._clock = clock
        self.registry = registry if registry is not None else Registry()
        self.metrics = _router_metrics(self.registry)
        self._lock = threading.Lock()
        self._replicas: dict[str, ReplicaView] = {}
        # prefill-role replicas (disaggregated prefill/decode): a
        # SEPARATE pool so the decode scorer can never place a
        # completion on a machine whose slots exist to absorb long
        # prefills — the isolation IS the feature. Same ReplicaView
        # shape (breakers, staleness) so polling and snapshots share
        # code with the decode side.
        self._prefill_replicas: dict[str, ReplicaView] = {}
        self._decisions = 0
        self._hits = 0

    # -- view maintenance ---------------------------------------------------

    def add_replica(self, name: str, url: str) -> ReplicaView:
        """Register (or re-register) a replica endpoint. Known names
        keep their view — re-adding after a restart preserves breaker
        history, which is what makes the half-open probe meaningful."""
        with self._lock:
            view = self._replicas.get(name)
            if view is None:
                view = ReplicaView(
                    name=name, url=url.rstrip("/"),
                    breaker=CircuitBreaker(
                        edge=f"router.proxy[{name}]",
                        failure_threshold=self._breaker_threshold,
                        reset_timeout_s=self._breaker_reset_s,
                        clock=self._clock,
                    ),
                )
                self._replicas[name] = view
            else:
                view.url = url.rstrip("/")
            return view

    def add_prefill_replica(self, name: str, url: str) -> ReplicaView:
        """Register a prefill-role replica (disaggregated prefill). It
        receives ONLY max_tokens=0 prefill-phase requests — never
        completions — and carries its own breaker so a dying prefill
        tier degrades to interleaved local prefill without poisoning
        decode routing. Names are shared with the decode pool in
        update_replica, so a name must not appear in both."""
        with self._lock:
            view = self._prefill_replicas.get(name)
            if view is None:
                view = ReplicaView(
                    name=name, url=url.rstrip("/"),
                    breaker=CircuitBreaker(
                        edge=f"router.prefill[{name}]",
                        failure_threshold=self._breaker_threshold,
                        reset_timeout_s=self._breaker_reset_s,
                        clock=self._clock,
                    ),
                )
                self._prefill_replicas[name] = view
            else:
                view.url = url.rstrip("/")
            return view

    def update_replica(self, name: str, serving: dict | None,
                       age_s: float = 0.0) -> None:
        """Authoritative refresh from a ``/cache/summary`` body's
        ``serving`` dict or a ``NodeState.serving_stats``. ``age_s``
        back-dates the signal (store mode: now - heartbeat) so
        staleness accounting works across clock domains. Replaces the
        fingerprint set wholesale — optimistic guesses the replica
        never confirmed die here, which is the correction half of the
        approximate-then-correct contract."""
        serving = serving if isinstance(serving, dict) else {}
        summary = serving.get("cache_summary")
        with self._lock:
            view = (self._replicas.get(name)
                    or self._prefill_replicas.get(name))
            if view is None:
                return
            view.serving = serving
            view.last_seen = self._clock() - max(0.0, age_s)
            if isinstance(summary, dict):
                fps = summary.get("fingerprints")
                if isinstance(fps, list):
                    view.fingerprints = set(fps)
                view.version = int(summary.get("version", view.version))
                view.block_size = int(
                    summary.get("block_size", view.block_size) or 0
                )

    def update_from_nodestates(self, states: Sequence, now: float) -> None:
        """Store-fed refresh: one pass over listed ``NodeState``
        objects. ``now`` is the store's wall clock (the same one that
        stamped the heartbeats); only replicas previously registered by
        name get updated — the store advertises no port, so endpoint
        registration stays explicit."""
        for s in states:
            if not getattr(s, "ready", False):
                continue
            hb = getattr(s, "heartbeat", 0.0)
            age = max(0.0, now - hb) if hb else 0.0
            self.update_replica(
                s.metadata.name, getattr(s, "serving_stats", None), age_s=age,
            )

    def mark_draining(self, name: str) -> None:
        """Locally mark a replica as draining ahead of its next poll.
        The proxy calls this on a 503 drain verdict so the re-route
        inside the SAME request already skips the replica — waiting
        for the poller would bounce every in-between request off the
        same 503. The next authoritative refresh replaces the serving
        dict wholesale, so an undrain clears this without ceremony."""
        with self._lock:
            view = (self._replicas.get(name)
                    or self._prefill_replicas.get(name))
            if view is not None:
                view.serving = dict(view.serving, draining=True)

    def note_routed(self, decision: RouteDecision,
                    tokens: Sequence[int]) -> None:
        """Optimistic insert after a successfully proxied request: the
        chosen replica's trie now holds this prompt's full blocks."""
        with self._lock:
            view = self._replicas.get(decision.replica)
            if view is None or not view.block_size:
                return
            if len(view.fingerprints) >= _OPTIMISTIC_CAP:
                return
            view.fingerprints.update(
                prefix_fingerprints(tokens, view.block_size)
            )

    def replicas(self) -> list[ReplicaView]:
        with self._lock:
            return list(self._replicas.values())

    def prefill_replicas(self) -> list[ReplicaView]:
        with self._lock:
            return list(self._prefill_replicas.values())

    def route_prefill(self, exclude: frozenset | set = frozenset()) -> ReplicaView:
        """Pick a prefill replica for the max_tokens=0 phase. No
        affinity axis: prefill output is exported by content address,
        so ANY prefill replica produces the same blocks — the only
        signal that matters is queue pressure (a prefill slot busy with
        someone else's long prompt is the head-of-line blocking this
        tier exists to absorb). Breaker gating uses peek() like the
        decode scorer: the proxy's RetryPolicy consumes the half-open
        probe, not candidacy. Ties break by name for replayability."""
        with self._lock:
            views = list(self._prefill_replicas.values())
        best: ReplicaView | None = None
        best_key: tuple[float, str] | None = None
        for view in views:
            if view.name in exclude:
                self.metrics["skipped"].inc(view.name, "failed")
                continue
            if view.breaker is not None and not view.breaker.peek():
                self.metrics["skipped"].inc(view.name, "breaker")
                continue
            if view.serving.get("draining"):
                self.metrics["skipped"].inc(view.name, "draining")
                continue
            key = (scoring.queue_pressure(view.serving), view.name)
            if best_key is None or key < best_key:
                best_key = key
                best = view
        if best is None:
            raise NoReplicaError(
                f"no routable prefill replica ({len(views)} known, "
                f"{len(exclude)} excluded this request)"
            )
        self.metrics["prefill_routed"].inc(best.name)
        return best

    # -- the decision -------------------------------------------------------

    def route(self, tokens: Sequence[int],
              exclude: frozenset | set = frozenset()) -> RouteDecision:
        """Score every eligible replica and pick the argmax.

        ``exclude`` names replicas that already failed THIS request
        (the proxy retries across replicas); they count as skipped with
        reason=failed. Ties break by replica name so two routers fed
        identical views agree — useful for replayable chaos runs.
        """
        faultpoints.fire("router.route")
        with _TRACER.span("router.route") as span:
            decision = self._route_locked(tokens, exclude)
            span.set(
                replica=decision.replica,
                match_blocks=decision.match_blocks,
                pressure=round(decision.pressure, 4),
                score=round(decision.score, 4),
                fallback=decision.fallback,
                candidates=decision.candidates,
            )
            return decision

    def _route_locked(self, tokens: Sequence[int],
                      exclude: frozenset | set) -> RouteDecision:
        now = self._clock()
        fps_by_bs: dict[int, list[int]] = {}
        counts = {"alive": 0, "stale": 0, "dead": 0, "draining": 0}
        best: tuple[float, str] | None = None
        best_info: RouteDecision | None = None
        n_scored = 0
        with self._lock:
            views = list(self._replicas.values())
        for view in views:
            if view.name in exclude:
                self.metrics["skipped"].inc(view.name, "failed")
                continue
            age = now - view.last_seen
            if age > self.dead_after_s:
                counts["dead"] += 1
                self.metrics["skipped"].inc(view.name, "dead")
                continue
            # peek, never allow(): candidacy must not consume the
            # half-open probe slot of a replica this decision may not
            # choose — the proxy's RetryPolicy is the one consumer
            if view.breaker is not None and not view.breaker.peek():
                self.metrics["skipped"].inc(view.name, "breaker")
                continue
            # draining replicas finish what they hold (the proxy keeps
            # relaying in-flight responses) but take no NEW placements;
            # a drain with zero healthy peers is the operator's call to
            # make, so NoReplicaError — not a silent placement onto the
            # very replica being emptied
            if view.serving.get("draining"):
                counts["draining"] += 1
                self.metrics["skipped"].inc(view.name, "draining")
                continue
            stale = age > self.stale_after_s
            counts["stale" if stale else "alive"] += 1
            bs = view.block_size
            if bs and bs not in fps_by_bs:
                fps_by_bs[bs] = prefix_fingerprints(tokens, bs)
            match = (
                scoring.match_depth(fps_by_bs[bs], view.fingerprints)
                if bs else 0
            )
            pressure = scoring.queue_pressure(view.serving)
            score = scoring.replica_score(
                match, pressure, stale, alpha=self.alpha,
                gamma=self.gamma, headroom=scoring.kv_headroom(view.serving),
            )
            n_scored += 1
            key = (score, view.name)
            # name ascending on equal score: (score, name) compared so
            # that HIGHER score wins but LOWER name wins ties
            if best is None or score > best[0] or (
                score == best[0] and view.name < best[1]
            ):
                best = key
                best_info = RouteDecision(
                    replica=view.name, url=view.url,
                    match_blocks=match, match_tokens=match * bs,
                    pressure=pressure, score=score, stale=stale,
                    fallback=False, candidates=0,
                )
        for state, n in counts.items():
            self.metrics["replicas"].set(state, n)
        if best_info is None:
            raise NoReplicaError(
                f"no routable replica ({len(views)} known, "
                f"{len(exclude)} excluded this request)"
            )
        fallback = best_info.match_blocks == 0
        decision = dataclasses.replace(
            best_info, fallback=fallback, candidates=n_scored
        )
        with self._lock:
            self._decisions += 1
            if not fallback:
                self._hits += 1
            ratio = self._hits / self._decisions
        if fallback:
            self.metrics["affinity_misses"].inc()
            self.metrics["routed"].inc(decision.replica, "fallback")
        else:
            self.metrics["affinity_hits"].inc()
            self.metrics["routed"].inc(decision.replica, "affinity")
        self.metrics["affinity_ratio"].set(ratio)
        return decision

    # -- the batched decision (storm mode) ----------------------------------

    def route_batch(
        self,
        token_batch: Sequence[Sequence[int]],
        excludes: Sequence[frozenset | set] | None = None,
        *,
        engine: str = "auto",
        mode: str = "parity",
    ) -> list[RouteDecision | None]:
        """Assign a whole arrival batch in one solve.

        Returns one ``RouteDecision`` per request (None = no routable
        replica; ``RouterServer`` answers it as ``route``'s
        NoReplicaError, with a 502). All requests share ONE view snapshot, taken under the
        lock; the solve itself runs outside it (the device work must
        never sit under the router lock).

        ``engine``: ``solver`` builds the [B, R] cost planes and solves
        on the router's device (solver/routing.py); ``python`` runs the
        per-request scorer over the same snapshot (the equivalence
        oracle, parity semantics only, taken only when named); ``auto``
        is the solver. ``mode`` is the solver's
        solve mode (parity/greedy/auction); decisions are rebuilt
        host-side from the chosen replica with the same float64 scoring
        as ``route``, so the B=1 parity case is byte-compatible with
        the single-request path under the documented tie-break (replica
        axis name-sorted; f32 solve score vs float64 scorer can differ
        only within f32 rounding of near-ties). The router's device
        decides kernel or plain version (``solve_routes`` has no
        ``accel``).
        """
        nb = len(token_batch)
        if nb == 0:
            return []
        if excludes is None:
            excludes = [frozenset()] * nb
        faultpoints.fire("router.route_batch")
        with _TRACER.span("router.route_batch") as span:
            t0 = time.perf_counter()
            now = self._clock()
            with self._lock:
                # fingerprint sets are mutated in place by note_routed;
                # the per-request scorer only does membership tests, but
                # the plane builder iterates — copy under the lock
                snap = sorted(
                    (
                        (v.name, v.url, frozenset(v.fingerprints),
                         v.block_size, v.serving, v.last_seen, v.breaker)
                        for v in self._replicas.values()
                    ),
                    key=lambda s: s[0],
                )
            n_views = len(snap)
            counts = {"alive": 0, "stale": 0, "dead": 0, "draining": 0}
            col_ok = np.zeros(n_views, bool)
            col_stale = np.zeros(n_views, bool)
            pressures = [0.0] * n_views
            slots = np.ones(n_views, np.float32)
            headroom = np.ones(n_views, np.float32)
            # float64 twin of the f32 solver plane: the python engine
            # and the host-side decision rebuild score in float64 (the
            # same math as route()), so B=1 parity stays byte-exact
            headroom_f64 = [1.0] * n_views
            name_col = {s[0]: r for r, s in enumerate(snap)}
            excl_counts = [0] * n_views
            for ex in excludes:
                for nm in ex:
                    r = name_col.get(nm)
                    if r is not None:
                        excl_counts[r] += 1
            for r, (name, _url, _fps, _bs, serving, last_seen,
                    breaker) in enumerate(snap):
                if excl_counts[r]:
                    self.metrics["skipped"].inc(
                        name, "failed", by=excl_counts[r]
                    )
                rest = nb - excl_counts[r]
                age = now - last_seen
                if age > self.dead_after_s:
                    counts["dead"] += 1
                    if rest:
                        self.metrics["skipped"].inc(name, "dead", by=rest)
                    continue
                # peek, never allow(): same half-open-probe rule as the
                # per-request scorer
                if breaker is not None and not breaker.peek():
                    if rest:
                        self.metrics["skipped"].inc(name, "breaker", by=rest)
                    continue
                if serving.get("draining"):
                    counts["draining"] += 1
                    if rest:
                        self.metrics["skipped"].inc(name, "draining", by=rest)
                    continue
                stale = age > self.stale_after_s
                counts["stale" if stale else "alive"] += 1
                col_ok[r] = True
                col_stale[r] = stale
                pressures[r] = scoring.queue_pressure(serving)
                slots[r] = float(serving.get("n_slots") or 1) \
                    if isinstance(serving, dict) else 1.0
                headroom_f64[r] = scoring.kv_headroom(serving)
                headroom[r] = headroom_f64[r]
            eligible = np.broadcast_to(col_ok, (nb, n_views)).copy()
            for b, ex in enumerate(excludes):
                for nm in ex:
                    r = name_col.get(nm)
                    if r is not None:
                        eligible[b, r] = False
            candidates = eligible.sum(axis=1, dtype=np.int32)
            if engine == "auto":
                engine = "solver"
            if engine == "solver":
                match = _routing.build_match_plane(
                    token_batch,
                    [s[2] for s in snap],
                    [s[3] for s in snap],
                )
                rp, _, _ = _routing.pack_route_arrays(
                    np.where(eligible, match, -1).astype(np.int32),
                    np.asarray(pressures, np.float32),
                    col_stale, slots, headroom, device=self.device,
                )
                picks = _routing.decode_routes(
                    _routing.solve_routes(
                        rp, alpha=float(self.alpha),
                        gamma=float(self.gamma), mode=mode,
                    ),
                    nb,
                )
            elif engine == "python":
                match, picks = self._batch_python_pick(
                    token_batch, snap, eligible, col_stale, pressures,
                    headroom_f64,
                )
            else:
                raise ValueError(f"unknown route engine {engine!r}")

            decisions: list[RouteDecision | None] = []
            hits = 0
            # per-(replica, reason) counter deltas batched into one inc
            # each — at B=256 per-decision inc calls are a measurable
            # slice of the chunk budget
            routed_by: dict[tuple[str, str], int] = {}
            for b in range(nb):
                r = int(picks[b])
                if r < 0:
                    decisions.append(None)
                    continue
                name, url, _fps, bs, _serving, _ls, _brk = snap[r]
                m = int(match[b, r])
                stale = bool(col_stale[r])
                score = scoring.replica_score(
                    m, pressures[r], stale, alpha=self.alpha,
                    gamma=self.gamma, headroom=headroom_f64[r],
                )
                fallback = m == 0
                decisions.append(RouteDecision(
                    replica=name, url=url, match_blocks=m,
                    match_tokens=m * bs, pressure=pressures[r],
                    score=score, stale=stale, fallback=fallback,
                    candidates=int(candidates[b]),
                ))
                if fallback:
                    key = (name, "fallback")
                else:
                    hits += 1
                    key = (name, "affinity")
                routed_by[key] = routed_by.get(key, 0) + 1
            routed = sum(1 for d in decisions if d is not None)
            if routed - hits:
                self.metrics["affinity_misses"].inc(by=routed - hits)
            if hits:
                self.metrics["affinity_hits"].inc(by=hits)
            for (name, reason), cnt in routed_by.items():
                self.metrics["routed"].inc(name, reason, by=cnt)
            for state, n in counts.items():
                self.metrics["replicas"].set(state, n)
            with self._lock:
                self._decisions += routed
                self._hits += hits
                ratio = (
                    self._hits / self._decisions if self._decisions else 0.0
                )
            self.metrics["affinity_ratio"].set(ratio)
            self.metrics["solve_seconds"].observe(time.perf_counter() - t0)
            self.metrics["batch_size"].set(nb)
            self.metrics["solver_routed"].inc(
                mode if engine == "solver" else "python", by=nb
            )
            span.set(batch=nb, engine=engine, mode=mode,
                     routed=routed, replicas=n_views)
            return decisions

    def _batch_python_pick(
        self,
        token_batch: Sequence[Sequence[int]],
        snap: list[tuple],
        eligible: np.ndarray,
        col_stale: np.ndarray,
        pressures: list[float],
        headrooms: list[float],
    ) -> tuple[np.ndarray, np.ndarray]:
        """The per-request scorer run over a shared snapshot: returns
        the (match plane, picks) pair the solver engine would — same
        gates, same (score desc, name asc) tie-break, float64 math."""
        nb, n_views = eligible.shape
        match = np.zeros((nb, n_views), np.int32)
        picks = np.full(nb, -1, np.int32)
        for b, tokens in enumerate(token_batch):
            fps_by_bs: dict[int, list[int]] = {}
            best: tuple[float, str] | None = None
            for r in range(n_views):
                if not eligible[b, r]:
                    continue
                name, _url, fps, bs, *_rest = snap[r]
                if bs and bs not in fps_by_bs:
                    fps_by_bs[bs] = prefix_fingerprints(tokens, bs)
                m = scoring.match_depth(fps_by_bs[bs], fps) if bs else 0
                match[b, r] = m
                score = scoring.replica_score(
                    m, pressures[r], bool(col_stale[r]), alpha=self.alpha,
                    gamma=self.gamma, headroom=headrooms[r],
                )
                if best is None or score > best[0] or (
                    score == best[0] and name < best[1]
                ):
                    best = (score, name)
                    picks[b] = r
        return match, picks

    @property
    def affinity_hit_rate(self) -> float:
        with self._lock:
            return self._hits / self._decisions if self._decisions else 0.0
