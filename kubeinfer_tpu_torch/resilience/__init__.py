"""Unified resilience layer: retry policy, circuit breaker, classification.

The reference operator is explicitly fragile under partial failure —
follower.go:117-149 has no retry/resume (SURVEY.md §2 #9), and every
other network edge (heartbeats, lease renewal, watch tailing) simply
propagates the first transport error. This package is the one home for
failure handling so every edge degrades the same way:

- ``RetryPolicy``: bounded attempts with exponential backoff and FULL
  jitter (delay ~ U(0, min(cap, base·2^attempt)) — the AWS-recommended
  variant: under a correlated outage, uniform jitter spreads the retry
  herd where equal-delay backoff synchronizes it), an overall deadline,
  and pluggable retryable-error classification. Per-attempt timeouts
  stay with the transport call (urlopen's ``timeout=``); the policy owns
  the *overall* budget.
- ``CircuitBreaker``: consecutive-failure trip → open (calls fail fast
  with ``BreakerOpenError``) → half-open probe after a cooldown → close
  on success. Fail-fast matters at the node-agent edge: during a store
  outage a tick must cost microseconds, not a full retry schedule, or
  heartbeat staleness accounting itself lags.
- Classifiers: ``transient_http`` (safe for idempotent requests),
  ``connect_failure`` (safe for ANY request — the request provably never
  reached the server), ``is_transport_error`` (breaker accounting: did
  the EDGE fail, regardless of whether this caller may retry).

Retry counts, exhaustions, and breaker transitions are exported through
``metrics.registry`` so degradation is observable, not silent. The
deterministic fault-injection harness that exercises all of this lives
in ``resilience.faultpoints``.

Every consumer passes an ``edge`` label naming the network edge
("store", "lease", "transfer.sync", ...) — docs/ARCHITECTURE.md's
"Failure handling" section is the catalogue.

A copy of ``kubeinfer_tpu/resilience/__init__.py`` for the PyTorch port.
Its locks are plain ``threading`` primitives: the reference's race-
checker hooks are no-ops outside an armed analysis run, and the race
checker is not ported.
"""

from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import urllib.error
from dataclasses import dataclass, field
from typing import Any, Callable

from kubeinfer_tpu_torch.metrics.registry import (
    breaker_state,
    breaker_transitions_total,
    retries_exhausted_total,
    retry_attempts_total,
)
from kubeinfer_tpu_torch.observability import tracing

__all__ = [
    "BreakerOpenError",
    "CircuitBreaker",
    "RetryPolicy",
    "connect_failure",
    "is_transport_error",
    "transient_http",
]


class BreakerOpenError(ConnectionError):
    """Raised instead of attempting a call while a breaker is open.

    Subclasses ConnectionError (→ OSError) so every existing transient-
    error handler (``except OSError`` in watch loops, agent ticks,
    replica tailing) treats a fast-failed call exactly like the
    connection failure it stands in for.
    """


def _http_code(exc: BaseException) -> int | None:
    if isinstance(exc, urllib.error.HTTPError):
        return exc.code
    return None


# 5xx the server may recover from, plus 429 throttling. 501/505 are
# permanent contract mismatches — retrying cannot help.
_RETRYABLE_HTTP = frozenset({429, 500, 502, 503, 504})


def transient_http(exc: BaseException) -> bool:
    """Retryable for IDEMPOTENT requests (GET/LIST/watch-page).

    Connection-level OSErrors (reset/refused/timeout), protocol-level
    HTTP client errors (short reads, bad status lines), URLErrors
    wrapping either, retryable HTTP status codes, and corrupt JSON
    payloads (a torn response body is a transport failure even though
    json surfaces it as ValueError).
    """
    code = _http_code(exc)
    if code is not None:
        return code in _RETRYABLE_HTTP
    return isinstance(
        exc,
        (OSError, http.client.HTTPException, urllib.error.URLError,
         json.JSONDecodeError),
    )


def connect_failure(exc: BaseException) -> bool:
    """Retryable for NON-idempotent requests (PUT/POST/DELETE): only
    failures that prove the request never reached the server — refused
    connections and name-resolution failures. A reset or timeout after
    connect may have landed the write; those callers rely on
    resourceVersion CAS (a replayed PUT surfaces ConflictError, which
    every store caller already handles as "re-read and retry")."""
    if isinstance(exc, (ConnectionRefusedError, socket.gaierror)):
        return True
    if isinstance(exc, urllib.error.URLError) and not isinstance(
        exc, urllib.error.HTTPError
    ):
        return isinstance(
            exc.reason, (ConnectionRefusedError, socket.gaierror)
        )
    return False


def is_transport_error(exc: BaseException) -> bool:
    """Breaker accounting: did the EDGE fail (vs. the server answering
    with a domain error)? Wider than any retry classifier — a 503 on a
    PUT is not retryable for that caller, but it still counts against
    the edge's health."""
    return transient_http(exc)


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff + full jitter, overall deadline, classification.

    ``classify`` decides retry eligibility; non-matching exceptions pass
    through on the first attempt (fail fast on real bugs and domain
    errors). ``deadline_s`` caps the TOTAL time spent including sleeps:
    a retry schedule must never outlive the caller's own failure
    detector (e.g. the replica promotion grace). 0 disables the cap.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    deadline_s: float = 30.0
    classify: Callable[[BaseException], bool] = transient_http

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Delay after the ``attempt``-th failure (0-based), full jitter."""
        cap = min(self.max_delay_s, self.base_delay_s * (2.0 ** attempt))
        return rng.random() * cap

    def call(
        self,
        fn: Callable[[], Any],
        *,
        edge: str = "",
        breaker: "CircuitBreaker | None" = None,
        rng: random.Random | None = None,
        sleep: Callable[[float], None] = time.sleep,
        clock: Callable[[], float] = time.monotonic,
    ) -> Any:
        """Run ``fn`` under this policy. ``rng``/``sleep``/``clock`` are
        injectable so backoff schedules are unit-testable (and so chaos
        scenarios replay identically under a seeded rng)."""
        rng = rng if rng is not None else random
        start = clock()
        attempt = 0
        while True:
            if breaker is not None and not breaker.allow():
                raise BreakerOpenError(
                    f"{edge or 'edge'}: circuit open; failing fast"
                )
            try:
                result = fn()
            except BaseException as exc:  # noqa: BLE001 — reclassified below
                if breaker is not None:
                    if is_transport_error(exc):
                        breaker.record_failure()
                    else:
                        # the server answered (404/409/...): the edge is
                        # healthy even though this call failed
                        breaker.record_success()
                if not self.classify(exc):
                    raise
                attempt += 1
                delay = self.backoff(attempt - 1, rng)
                out_of_budget = (
                    attempt >= self.max_attempts
                    or (
                        self.deadline_s > 0
                        and clock() + delay - start > self.deadline_s
                    )
                )
                if out_of_budget:
                    if edge:
                        retries_exhausted_total.inc(edge)
                    # span events mirror the counters so a chaos run's
                    # trace explains WHICH request burned its budget
                    # (no-ops outside an active span)
                    tracing.add_event(
                        "retries-exhausted", edge=edge, attempts=attempt,
                        error=type(exc).__name__,
                    )
                    raise
                if edge:
                    retry_attempts_total.inc(edge)
                tracing.add_event(
                    "retry", edge=edge, attempt=attempt,
                    error=type(exc).__name__, delay_s=round(delay, 4),
                )
                sleep(delay)
            else:
                if breaker is not None:
                    breaker.record_success()
                return result


# Breaker state encoding for the kubeinfer_breaker_state gauge.
_STATE_CODE = {"closed": 0, "open": 1, "half-open": 2}


class CircuitBreaker:
    """Consecutive-failure breaker with half-open probing.

    closed → (``failure_threshold`` consecutive transport failures) →
    open → (``reset_timeout_s`` elapsed) → half-open, which admits ONE
    probe call: success closes, failure re-opens (and restarts the
    cooldown). Thread-safe; one instance guards one edge.
    """

    def __init__(
        self,
        edge: str = "",
        failure_threshold: int = 5,
        reset_timeout_s: float = 1.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.edge = edge
        self._threshold = max(1, failure_threshold)
        self._reset = reset_timeout_s
        self._clock = clock
        self._mu = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_at = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._mu:
            return self._state

    def _transition(self, to: str) -> None:
        # caller holds _mu
        if self._state == to:
            return
        self._state = to
        if self.edge:
            breaker_transitions_total.inc(self.edge, to)
            breaker_state.set(self.edge, _STATE_CODE[to])

    def peek(self) -> bool:
        """Would ``allow()`` plausibly admit a call right now?
        Read-only: neither transitions open -> half-open nor consumes
        the half-open probe slot. Candidacy filters (the fleet router's
        scoring loop) use this — calling ``allow()`` from a filter
        would burn the single probe on a replica the filter may not
        even choose, and an unconsumed probe wedges the breaker
        half-open forever."""
        with self._mu:
            if self._state == "closed":
                return True
            if self._state == "open":
                return self._clock() - self._opened_at >= self._reset
            return not self._probing

    def allow(self) -> bool:
        with self._mu:
            if self._state == "closed":
                return True
            if self._state == "open":
                if self._clock() - self._opened_at >= self._reset:
                    self._transition("half-open")
                    self._probing = True
                    return True
                return False
            # half-open: exactly one in-flight probe decides the state;
            # everyone else keeps failing fast until it reports
            if not self._probing:
                self._probing = True
                return True
            return False

    def record_success(self) -> None:
        with self._mu:
            self._failures = 0
            self._probing = False
            self._transition("closed")

    def record_failure(self) -> None:
        with self._mu:
            self._failures += 1
            self._probing = False
            if self._state == "half-open" or self._failures >= self._threshold:
                self._opened_at = self._clock()
                self._transition("open")
