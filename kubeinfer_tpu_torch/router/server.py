"""HTTP front door: proxy, summary poller, and CLI.

One process, three loops:

- ``RouterServer`` accepts OpenAI-style ``POST /v1/completions`` and
  forwards the raw body to the replica ``FleetRouter.route`` picks,
  under a per-replica RetryPolicy + CircuitBreaker. A transport
  failure re-scores with the failed replica excluded — the request
  only errors out when EVERY replica is unreachable, so one dead
  replica degrades routing (colder caches, fewer candidates), never
  correctness.
- A poller thread refreshes each replica's view from
  ``GET /cache/summary`` every ``poll_interval_s``. Store-fed
  deployments skip the poller and call
  ``FleetRouter.update_from_nodestates`` off a NodeState list instead;
  both sources land in the same ``update_replica``.
- ``/metrics`` renders the router's own registry (kubeinfer_router_*
  plus the shared retry/breaker series its RetryPolicy feeds).

With ``--prefill-replica`` endpoints registered, long prompts take a
TWO-PHASE route (disaggregated prefill/decode): phase one POSTs the
prompt with ``max_tokens=0`` to a prefill-role replica, which exports
the resulting KV blocks by content address; phase two is the normal
decode placement, with the body annotated (``kubeinfer_kv_source``) so
the chosen decode replica streams the blocks over /kv/blocks instead
of recomputing the prefill. Every failure along the way — prefill tier
down, export evicted, wire corruption — degrades to the single-phase
route with its interleaved local prefill, which is token-identical by
the determinism contract.

The proxy retries only failures that prove the request never reached
the replica (resilience.connect_failure): generation is deterministic
per (prompt, seed, sampling), so a replay is token-identical, but a
reset mid-response may have burned slot time — those surface to the
client like any single-server error would.

A copy of ``kubeinfer_tpu/router/server.py`` for the PyTorch port. Its
lock is a plain ``threading.Lock`` (the race checker is not ported).
``main`` takes the reference's flags plus ``--device`` (default
``cuda``): where the batched route solve of ``--storm-window-ms`` runs;
without a card it exits 1 with "CUDA is not available (--device cuda)".
Unlike the reference, a storm-window request whose batched solve fails
or comes too late is answered 503 (``route_solve_failed``): it is never
routed by the per-request scorer instead.
"""

from __future__ import annotations

import argparse
import json
import logging
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

# the checkpoint's HF tokenizer or None (id-only: string prompts route
# least-loaded, counted), loaded as the inference server loads it
from kubeinfer_tpu_torch.inference.server import _load_tokenizer
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.resilience import RetryPolicy, connect_failure, faultpoints
from kubeinfer_tpu_torch.router.core import (
    FleetRouter,
    NoReplicaError,
    RouteDecision,
)
from kubeinfer_tpu_torch.utils.httpbase import BaseEndpointHandler, inject_traceparent

log = logging.getLogger(__name__)

_TRACER = tracing.get_tracer("router")

# One connect-failure retry per replica before re-scoring elsewhere:
# the cross-replica loop is the real retry budget, and burning a full
# backoff schedule on a dead replica just adds tail latency before the
# router does the thing it exists to do (route around it).
_PROXY_POLICY = RetryPolicy(
    max_attempts=2, base_delay_s=0.05, max_delay_s=0.2,
    deadline_s=10.0, classify=connect_failure,
)

# Resume-hop budget per request: each hop means the replica that was
# SERVING the generation started draining mid-flight, so >1 only
# happens during rolling rebalances. The cap exists because a fleet
# where every replica is perpetually draining would otherwise bounce a
# session forever; at the limit the last partial response is relayed
# (finish_reason="migrated", tokens-so-far intact — the client resumes
# or resubmits, nothing is lost).
_MAX_MIGRATION_HOPS = 3


class _StormEntry:
    """One queued request in a storm batch."""

    __slots__ = ("tokens", "exclude", "done", "decision", "error")

    def __init__(self, tokens, exclude) -> None:
        self.tokens = tokens
        self.exclude = exclude
        self.done = threading.Event()
        self.decision: RouteDecision | None = None
        self.error: BaseException | None = None


class _StormBatcher:
    """Micro-batching admission: requests arriving within the window
    (or while a batched solve is in flight) queue and get assigned by
    ONE ``FleetRouter.route_batch`` call instead of N sequential scans.

    Leader election is arrival-order: the request that finds no leader
    becomes one, sleeps out the window while followers append, then
    drains the queue and solves. The leader flag drops BEFORE the solve
    runs — arrivals during a solve elect the next leader immediately,
    so solve latency pipelines with the next window instead of
    serializing behind it. A solve that raises fails every request of
    its batch with the same error, and a follower that outwaits
    ``follower_timeout_s`` (long enough for a first solve that builds
    the route pick) raises TimeoutError: neither falls back to the
    per-request scorer, so the batcher can delay or fail a request but
    never strand one or route it off the solver.
    """

    def __init__(self, router: FleetRouter, window_s: float,
                 mode: str = "parity") -> None:
        self.router = router
        self.window_s = window_s
        self.mode = mode
        self._lock = threading.Lock()
        self._pending: list[_StormEntry] = []
        self._leader = False
        self.follower_timeout_s = window_s * 10 + 120.0

    def route(self, tokens, exclude) -> RouteDecision | None:
        """The request's decision from a shared solve (None = no
        routable replica). Raises what the solve raised, or
        TimeoutError past ``follower_timeout_s``."""
        entry = _StormEntry(tokens, frozenset(exclude))
        with self._lock:
            self._pending.append(entry)
            lead = not self._leader
            if lead:
                self._leader = True
        if lead:
            time.sleep(self.window_s)
            with self._lock:
                batch = self._pending
                self._pending = []
                self._leader = False
            try:
                decisions = self.router.route_batch(
                    [e.tokens for e in batch],
                    [e.exclude for e in batch],
                    mode=self.mode,
                )
            except BaseException as e:
                for f in batch:
                    f.error = e
                raise
            else:
                for f, d in zip(batch, decisions):
                    f.decision = d
            finally:
                for f in batch:
                    f.done.set()
            return entry.decision
        if entry.done.wait(timeout=self.follower_timeout_s):
            if entry.error is not None:
                raise entry.error
            return entry.decision
        # orphaned follower: pull the entry back so a late leader
        # drain can't double-assign it, then fail the request
        with self._lock:
            if entry in self._pending:
                self._pending.remove(entry)
        raise TimeoutError(
            f"no route solve within {self.follower_timeout_s:.1f} s"
        )


class RouterServer:
    """Fleet front door over a FleetRouter."""

    def __init__(self, router: FleetRouter, host: str = "127.0.0.1",
                 port: int = 0, poll_interval_s: float = 2.0,
                 upstream_timeout_s: float = 300.0,
                 prefill_threshold: int | None = None,
                 rng: random.Random | None = None,
                 tokenizer=None,
                 storm_window_s: float = 0.0,
                 storm_mode: str = "parity") -> None:
        from kubeinfer_tpu_torch.router import scoring

        self.router = router
        self.poll_interval_s = poll_interval_s
        self.upstream_timeout_s = upstream_timeout_s
        # optional, duck-typed (anything with .encode(str) -> ids):
        # lets string prompts fingerprint-match instead of degrading to
        # least-loaded. None keeps the router model-asset-free.
        self.tokenizer = tokenizer
        # storm mode: micro-batch the first placement of concurrent
        # arrivals through one route_batch solve. 0 = off (every
        # request takes the single-request path)
        self._storm = (
            _StormBatcher(router, storm_window_s, storm_mode)
            if storm_window_s > 0 else None
        )
        # disaggregated prefill cutoff: prompts at least this long take
        # the two-phase route when prefill replicas are registered
        self.prefill_threshold = (
            prefill_threshold if prefill_threshold is not None
            else scoring.DEFAULT_PREFILL_THRESHOLD_TOKENS
        )
        # seeded-injectable rng: chaos runs replay the retry jitter
        self._rng = rng if rng is not None else random.Random()
        self._stop = threading.Event()
        self._poller: threading.Thread | None = None
        server = self

        class Handler(BaseEndpointHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    self.respond(200, "text/plain", "OK")
                elif path == "/metrics":
                    self.respond(
                        200, "text/plain; version=0.0.4",
                        server.router.registry.render(),
                    )
                elif path == "/replicas":
                    self.respond(
                        200, "application/json",
                        json.dumps(server.replica_snapshot()),
                    )
                else:
                    self.respond(404, "text/plain", "not found\n")

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if path != "/v1/completions":
                    self.respond(404, "text/plain", "not found\n")
                    return
                with _TRACER.span(
                    "http POST /v1/completions",
                    parent=self.trace_context(),
                ) as sp:
                    try:
                        code, payload = server.forward(raw)
                        sp.set(status=code)
                        self.respond(code, "application/json", payload)
                    except Exception as e:  # keep the thread alive
                        log.exception("router forward failed")
                        sp.set(status=502)
                        self.respond(502, "application/json", json.dumps({
                            "error": {"message": str(e),
                                      "type": "router_error"},
                        }))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- request path -------------------------------------------------------

    def forward(self, raw_body: bytes) -> tuple[int, bytes]:
        """Route + proxy one completions request; returns (status,
        body) to relay verbatim (plus a routing annotation). Callable
        without the HTTP listener — bench drives this directly."""
        try:
            body = json.loads(raw_body or b"{}")
        except ValueError:
            return 400, json.dumps({"error": {
                "message": "request body is not JSON",
                "type": "invalid_request_error"}}).encode()
        prompt = body.get("prompt")
        # token-id prompts are scorable as-is; string prompts go
        # through the optional tokenizer so they fingerprint-match too
        # (and feed the same optimistic note_routed update below) —
        # without one they still route, degrading to counted
        # least-loaded fallbacks
        tokens = (
            prompt if isinstance(prompt, list)
            and all(isinstance(t, int) for t in prompt) else []
        )
        if not tokens and isinstance(prompt, str) and prompt:
            tokens = self._encode_prompt(prompt)
        # disaggregated two-phase route: long prompts prefill on a
        # prefill-role replica first (max_tokens=0 — the replica
        # exports the KV blocks by content address), then the decode
        # placement below proceeds normally with the body annotated so
        # the chosen decode replica pulls the blocks instead of
        # recomputing. Every failure mode degrades to the single-phase
        # route — interleaved local prefill, token-identical by the
        # determinism contract — so this block can only add latency,
        # never errors.
        max_tokens = body.get("max_tokens", 16)
        if (
            tokens
            and len(tokens) >= self.prefill_threshold
            and isinstance(max_tokens, int) and max_tokens > 0
            and self.router.prefill_replicas()
        ):
            kv_source = self._prefill_phase(tokens, body)
            if kv_source is not None:
                body["kubeinfer_kv_source"] = kv_source
                raw_body = json.dumps(body).encode()
        tried: set[str] = set()
        hops = 0
        first = True
        parked: tuple[bytes, object] | None = None
        while True:
            decision = None
            # storm admission covers only the FIRST placement: retries
            # and migration resumes already hold per-request exclusion
            # state that a shared batch would smear across requests,
            # and they are rare enough that batching buys nothing
            if self._storm is not None and first and not tried:
                # the solve's verdict is final: a failed or late solve
                # fails the request (no per-request scorer behind it),
                # and no routable replica is route()'s 502
                try:
                    decision = self._storm.route(tokens, tried)
                except Exception as e:  # noqa: BLE001 — solve failure
                    log.error("storm route solve failed (%s: %s)",
                              type(e).__name__, e)
                    return 503, json.dumps({"error": {
                        "message": f"route solve failed: {e}",
                        "type": "route_solve_failed"}}).encode()
                if decision is None:
                    return 502, json.dumps({"error": {
                        "message": "no routable replica",
                        "type": "no_replica"}}).encode()
            first = False
            if decision is None:
                try:
                    decision = self.router.route(tokens, exclude=tried)
                except NoReplicaError as e:
                    if parked is not None:
                        # the resume has nowhere to go (every peer
                        # dead, draining, or failed): relay the
                        # source's partial verbatim —
                        # finish_reason="migrated" with the
                        # tokens-so-far intact, so the client holds
                        # everything generated and nothing is lost
                        self.router.metrics["migration_fallbacks"].inc(
                            "no_target"
                        )
                        return 200, self._annotate(
                            parked[0], parked[1], hops
                        )
                    return 502, json.dumps({"error": {
                        "message": str(e),
                        "type": "no_replica"}}).encode()
            try:
                payload = self._proxy(decision, raw_body)
            except urllib.error.HTTPError as e:
                err_body = e.read()
                # a drain verdict is the one 5xx that is guaranteed
                # replica-specific: the engine refused ADMISSION, it
                # did not fail the request — mark the view (the next
                # poll would, but every request in between would bounce
                # off the same 503) and re-score elsewhere
                if e.code == 503 and self._is_drain_verdict(err_body):
                    self.router.mark_draining(decision.replica)
                    self.router.metrics["requests"].inc(
                        decision.replica, "draining"
                    )
                    tried.add(decision.replica)
                    continue
                # the replica ANSWERED (4xx/5xx): relay its verdict —
                # a validation error would fail identically anywhere
                self.router.metrics["requests"].inc(
                    decision.replica, f"http_{e.code}"
                )
                return e.code, err_body
            except Exception as e:  # noqa: BLE001 — transport failure
                log.warning("replica %s unreachable (%s); re-scoring",
                            decision.replica, type(e).__name__)
                self.router.metrics["requests"].inc(
                    decision.replica, "unreachable"
                )
                tried.add(decision.replica)
                continue
            self.router.metrics["requests"].inc(decision.replica, "ok")
            if tokens:
                self.router.note_routed(decision, tokens)
            if hops:
                self.router.metrics["migration_resumes"].inc(
                    decision.replica
                )
            # live-session migration: the replica drained mid-flight
            # and handed back its generation-so-far instead of
            # finishing — resume on another replica with the body
            # annotated so the target can stream the source's KV chain
            # (or re-prefill token-identically when it can't)
            migrated = self._migrated_ext(payload)
            if migrated is not None:
                if hops >= _MAX_MIGRATION_HOPS:
                    self.router.metrics["migration_fallbacks"].inc(
                        "hop_limit"
                    )
                    return 200, self._annotate(payload, decision, hops)
                hops += 1
                parked = (payload, decision)
                raw_body = self._resume_body(body, migrated, decision.url)
                # only the source is excluded: earlier transport
                # failures get a fresh chance — the resume is a NEW
                # placement and the breaker still gates dead peers
                tried = {decision.replica}
                continue
            return 200, self._annotate(payload, decision, hops)

    def _encode_prompt(self, prompt: str) -> list[int]:
        """Resolve a string prompt to token ids for scoring. Encoding
        never fails the request — the ids exist only to fingerprint;
        the replica re-tokenizes the prompt string itself — so any
        miss (no tokenizer, encode error, exotic return type) counts
        the fallback and routes least-loaded like before."""
        if self.tokenizer is not None:
            try:
                ids = self.tokenizer.encode(prompt)
                if isinstance(ids, list) and all(
                    isinstance(t, int) for t in ids
                ):
                    return ids
            except Exception as e:  # noqa: BLE001 — score-path only
                log.warning("tokenizer encode failed (%s); "
                            "least-loaded fallback", type(e).__name__)
        self.router.metrics["tokenizer_fallback"].inc()
        return []

    @staticmethod
    def _is_drain_verdict(err_body: bytes) -> bool:
        """Is this error body the inference server's 503
        {"error": {"type": "draining"}} admission refusal? Anything
        else 503-shaped (a proxy in between, an OOM handler) relays
        like a normal upstream verdict."""
        try:
            doc = json.loads(err_body or b"{}")
        except ValueError:
            return False
        err = doc.get("error") if isinstance(doc, dict) else None
        return isinstance(err, dict) and err.get("type") == "draining"

    @staticmethod
    def _migrated_ext(payload: bytes) -> dict | None:
        """Extract the ``kubeinfer.migrated`` hand-off from a replica
        response, or None for a normally finished generation. The
        hand-off carries the tokens generated so far and how many KV
        blocks the source streamed into its export cache."""
        try:
            doc = json.loads(payload)
        except ValueError:
            return None
        if not isinstance(doc, dict):
            return None
        migrated = (doc.get("kubeinfer") or {}).get("migrated")
        return migrated if isinstance(migrated, dict) else None

    @staticmethod
    def _resume_body(body: dict, migrated: dict,
                     source_url: str) -> bytes:
        """Build the resume-hop request: same prompt and sampling
        params (token identity needs the original seed), annotated
        with the source's generation-so-far. ``kv_source`` is only
        attached when the source actually streamed chunks — with zero
        blocks exported a chain fetch could only burn the target's
        TTFT before the same re-prefill; the prefill-phase annotation
        (strictly shallower than the migration chain) is dropped for
        the same reason whenever the chain is present."""
        resume: dict = {"tokens": list(migrated.get("tokens") or [])}
        out = dict(body)
        if migrated.get("blocks"):
            resume["kv_source"] = source_url
            out.pop("kubeinfer_kv_source", None)
        out["kubeinfer_resume"] = resume
        return json.dumps(out).encode()

    def _prefill_phase(self, tokens: list[int],
                       body: dict) -> str | None:
        """Run the prefill phase of a two-phase request: POST the
        prompt with ``max_tokens=0`` to a prefill-role replica so its
        export cache holds this prefix's KV, and return that replica's
        URL for the ``kubeinfer_kv_source`` annotation. Returns None
        when the phase is skipped or failed — the caller proceeds
        single-phase. Retries across prefill replicas like forward()
        does across decode replicas; each attempt rides the replica's
        own breaker, so a dead prefill tier trips open and subsequent
        requests skip the phase at peek() cost."""
        pre_body = dict(body)
        pre_body["max_tokens"] = 0
        pre_body.pop("kubeinfer_kv_source", None)
        raw = json.dumps(pre_body).encode()
        tried: set[str] = set()
        while True:
            try:
                view = self.router.route_prefill(exclude=tried)
            except NoReplicaError:
                self.router.metrics["disagg_fallbacks"].inc(
                    "prefill_unreachable"
                )
                return None

            def attempt() -> bytes:
                faultpoints.fire("router.prefill", key=view.name)
                req = urllib.request.Request(
                    view.url + "/v1/completions",
                    data=raw,
                    headers=inject_traceparent(
                        {"Content-Type": "application/json"}
                    ),
                    method="POST",
                )
                with urllib.request.urlopen(
                    req, timeout=self.upstream_timeout_s
                ) as resp:
                    return resp.read()

            try:
                _PROXY_POLICY.call(
                    attempt, edge="router.prefill",
                    breaker=view.breaker, rng=self._rng,
                )
            except urllib.error.HTTPError:
                # the replica ANSWERED with a verdict (e.g. the prompt
                # exceeds its cache): another prefill replica of the
                # same fleet would refuse identically, so skip the
                # phase rather than spin
                self.router.metrics["disagg_fallbacks"].inc(
                    "prefill_rejected"
                )
                return None
            except Exception as e:  # noqa: BLE001 — transport failure
                log.warning(
                    "prefill replica %s unreachable (%s); re-scoring",
                    view.name, type(e).__name__,
                )
                tried.add(view.name)
                continue
            return view.url

    def _proxy(self, decision, raw_body: bytes) -> bytes:
        """One replica attempt under the per-replica retry policy and
        breaker. The traceparent header carries the router's active
        span, so the replica's server-side spans join this trace."""
        view = next(
            (v for v in self.router.replicas()
             if v.name == decision.replica), None
        )

        def attempt() -> bytes:
            faultpoints.fire("router.proxy", key=decision.replica)
            req = urllib.request.Request(
                decision.url + "/v1/completions",
                data=raw_body,
                headers=inject_traceparent(
                    {"Content-Type": "application/json"}
                ),
                method="POST",
            )
            with urllib.request.urlopen(
                req, timeout=self.upstream_timeout_s
            ) as resp:
                return resp.read()

        return _PROXY_POLICY.call(
            attempt,
            edge="router.proxy",
            breaker=view.breaker if view is not None else None,
            rng=self._rng,
        )

    @staticmethod
    def _annotate(payload: bytes, decision, hops: int = 0) -> bytes:
        """Stamp the routing decision into the response's ``kubeinfer``
        extension block so clients (and the chaos test) can see which
        replica served, whether affinity hit, and how many migration
        hops the session survived on the way."""
        try:
            doc = json.loads(payload)
        except ValueError:
            return payload
        if not isinstance(doc, dict):
            return payload
        ext = doc.setdefault("kubeinfer", {})
        ext["replica"] = decision.replica
        ext["match_blocks"] = decision.match_blocks
        ext["fallback"] = decision.fallback
        if hops:
            ext["resume_hops"] = hops
        return json.dumps(doc).encode()

    # -- replica-state refresh ----------------------------------------------

    def poll_once(self, timeout_s: float = 5.0) -> int:
        """One authoritative refresh pass over every known replica;
        returns how many answered. Unreachable replicas keep their
        (aging) view — staleness scoring and the breaker handle them;
        the poller never unregisters anything."""
        ok = 0
        # both roles refresh from the same endpoint: prefill replicas
        # need fresh queue pressure for route_prefill, and their
        # staleness/breaker bookkeeping shares the decode machinery
        for view in self.router.replicas() + self.router.prefill_replicas():
            try:
                with urllib.request.urlopen(
                    view.url + "/cache/summary", timeout=timeout_s
                ) as resp:
                    doc = json.loads(resp.read())
            except Exception:  # noqa: BLE001 — poller must outlive outages
                continue
            self.router.update_replica(view.name, doc.get("serving"))
            ok += 1
        return ok

    def _poll_loop(self) -> None:
        while not self._stop.wait(self.poll_interval_s):
            self.poll_once()

    def replica_snapshot(self) -> list[dict]:
        now = self.router._clock()
        return [
            {
                "name": v.name,
                "url": v.url,
                "role": role,
                "fingerprints": len(v.fingerprints),
                "version": v.version,
                "queue_depth": v.serving.get("queue_depth"),
                "age_s": (
                    round(now - v.last_seen, 3)
                    if v.last_seen != float("-inf") else None
                ),
                "breaker": v.breaker.state if v.breaker else "none",
            }
            for role, views in (
                ("decode", self.router.replicas()),
                ("prefill", self.router.prefill_replicas()),
            )
            for v in views
        ]

    # -- lifecycle ----------------------------------------------------------

    def start(self, poll: bool = True) -> "RouterServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"router-server-{self.port}",
        )
        self._thread.start()
        if poll and self.poll_interval_s > 0:
            self._poller = threading.Thread(
                target=self._poll_loop, daemon=True, name="router-poller",
            )
            self._poller.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._poller is not None:
            self._poller.join(timeout=5.0)
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="kubeinfer-router")
    p.add_argument("--replica", action="append", default=[],
                   metavar="NAME=URL", required=True,
                   help="inference server endpoint, repeatable "
                        "(e.g. r0=http://10.0.0.5:8000)")
    p.add_argument("--prefill-replica", action="append", default=[],
                   metavar="NAME=URL",
                   help="prefill-role endpoint, repeatable; long "
                        "prompts prefill here first (max_tokens=0) and "
                        "stream their KV blocks to the decode replica "
                        "(disaggregated prefill/decode)")
    p.add_argument("--prefill-threshold", type=int, default=None,
                   help="minimum prompt tokens for the two-phase route "
                        "(default: scoring."
                        "DEFAULT_PREFILL_THRESHOLD_TOKENS)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--alpha", type=float,
                   default=None, help="queue-pressure weight in blocks "
                   "(default: scoring.ALPHA_QUEUE_BLOCKS)")
    p.add_argument("--headroom-weight", type=float, default=0.0,
                   help="KV-fullness weight in blocks: each replica's "
                        "score drops by weight * (1 - free pool "
                        "fraction), steering arrivals off "
                        "eviction-pressured replicas (0 = off, "
                        "byte-identical routing)")
    p.add_argument("--poll-interval", type=float, default=2.0,
                   help="seconds between /cache/summary refreshes")
    p.add_argument("--tokenizer", default=None, metavar="DIR",
                   help="tokenizer files (HF layout) so string prompts "
                        "fingerprint-match; absent or unloadable = "
                        "id-only mode with counted fallbacks")
    p.add_argument("--storm-window-ms", type=float, default=0.0,
                   help="micro-batching window: concurrent arrivals "
                        "within it are assigned by one batched route "
                        "solve (0 = off)")
    p.add_argument("--storm-mode", default="parity",
                   choices=("parity", "greedy", "auction"),
                   help="batched solve mode: parity = per-request "
                        "argmax semantics; greedy/auction spread the "
                        "batch across replicas")
    p.add_argument("--device", default="cuda",
                   help="where the batched route solve runs: cuda (the "
                        "default; fails without a card) or cpu (the plain "
                        "PyTorch versions, for tests)")
    args = p.parse_args(argv)

    from kubeinfer_tpu_torch.router import scoring

    try:
        router = FleetRouter(
            alpha=args.alpha if args.alpha is not None
            else scoring.ALPHA_QUEUE_BLOCKS,
            gamma=args.headroom_weight,
            device=args.device,
        )
    except RuntimeError as e:  # the device is not there
        log.error("%s (--device %s)", e, args.device)
        return 1
    for spec in args.replica:
        name, _, url = spec.partition("=")
        if not url:
            p.error(f"--replica needs NAME=URL, got {spec!r}")
        router.add_replica(name, url)
    for spec in args.prefill_replica:
        name, _, url = spec.partition("=")
        if not url:
            p.error(f"--prefill-replica needs NAME=URL, got {spec!r}")
        router.add_prefill_replica(name, url)
    srv = RouterServer(router, host=args.host, port=args.port,
                       poll_interval_s=args.poll_interval,
                       prefill_threshold=args.prefill_threshold,
                       tokenizer=(_load_tokenizer(args.tokenizer)
                                  if args.tokenizer else None),
                       storm_window_s=args.storm_window_ms / 1000.0,
                       storm_mode=args.storm_mode)
    srv.poll_once()
    srv.start()
    log.info("router listening on :%d over %d decode + %d prefill "
             "replicas", srv.port, len(router.replicas()),
             len(router.prefill_replicas()))
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
