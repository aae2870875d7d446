"""Deterministic fault injection: named points compiled into network edges.

Chaos testing that depends on real packet loss is unreproducible; this
harness makes failure a first-class, *seeded* input instead. Each
network edge calls ``fire("<point>", key=...)`` (and payload edges call
``mangle``) unconditionally — the disarmed fast path is one attribute
read, so production cost is nil — and an armed ``FaultSpec`` decides
per pass, from a seeded RNG, whether to inject.

Fault points (the catalogue docs/ARCHITECTURE.md documents):

- ``store.request``   RemoteStore._req, key ``"METHOD /path"``
- ``agent.heartbeat`` NodeAgent.heartbeat, key = node name
- ``lease.renew``     LeaseManager.try_acquire_or_renew, key = identity
- ``transfer.fetch``  transfer list/download, key = relative path
- ``runtime.health``  RuntimeServer.wait_healthy poll, key = health URL

Modes:

- ``error``:     raise (``kind``: reset | refused | timeout | http_503 /
                 http_500 / http_429 — any ``http_<code>``)
- ``latency``:   sleep ``delay_s`` then proceed
- ``blackhole``: sleep ``delay_s`` then raise TimeoutError — a hung
                 connection whose client-side timeout eventually fires,
                 without actually holding a socket open for the test
- ``corrupt``:   mangle the payload bytes (``mangle()`` edges only)

Arming: programmatic (``REGISTRY.arm(FaultSpec(...))``, tests) or via
``KUBEINFER_FAULTS="point:mode[:k=v[,k=v...]];..."`` +
``KUBEINFER_FAULT_SEED`` in the environment (manual chaos drills; parsed
lazily on first fire so importing this module never costs env parsing).
Same seed + same call sequence → same fault sequence → same outcome;
``REGISTRY.log`` records every firing for determinism assertions.

A copy of ``kubeinfer_tpu/resilience/faultpoints.py`` for the PyTorch
port. ``KUBEINFER_FAULTS`` is read as the reference reads it. Its locks
are plain ``threading`` primitives: the reference's race-checker hooks
are no-ops outside an armed analysis run, and the race checker is not
ported. The schedule fuzzer's yield point is left out with it.
"""

from __future__ import annotations

import email.message
import io
import os
import random
import threading
import time
import urllib.error
from dataclasses import dataclass, field

from kubeinfer_tpu_torch.metrics.registry import fault_injections_total
from kubeinfer_tpu_torch.observability import tracing

__all__ = ["FaultSpec", "FaultRegistry", "REGISTRY", "fire", "mangle"]


@dataclass
class FaultSpec:
    """One armed fault. ``match`` (substring of the call-site ``key``)
    narrows a point to specific traffic — e.g. only ``/watch`` long
    polls, only one lease identity. ``after`` skips the first N matching
    passes; ``count`` caps total firings (-1 = unlimited); ``rate``
    fires probabilistically from the registry's seeded RNG."""

    point: str
    mode: str  # error | latency | blackhole | corrupt
    kind: str = "reset"  # error mode: reset|refused|timeout|http_<code>
    match: str = ""
    rate: float = 1.0
    count: int = -1
    after: int = 0
    delay_s: float = 0.05
    # internal counters (per-spec, so independent specs don't interact)
    passes: int = field(default=0, repr=False)
    fired: int = field(default=0, repr=False)


def _make_error(kind: str) -> BaseException:
    if kind == "reset":
        return ConnectionResetError("injected: connection reset")
    if kind == "refused":
        return ConnectionRefusedError("injected: connection refused")
    if kind == "timeout":
        return TimeoutError("injected: timed out")
    if kind.startswith("http_"):
        code = int(kind.split("_", 1)[1])
        return urllib.error.HTTPError(
            "http://injected.invalid/", code, "injected fault",
            email.message.Message(), io.BytesIO(b"{}"),
        )
    raise ValueError(f"unknown fault kind {kind!r}")


class FaultRegistry:
    """Process-global fault state. Tests arm/disarm around scenarios;
    ``seed()`` resets the RNG *and* per-spec counters so a re-armed
    scenario replays bit-identically."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._specs: list[FaultSpec] = []
        self._rng = random.Random(0)
        self._env_checked = False
        self.log: list[tuple[str, str, str]] = []  # (point, mode, key)

    # -- arming -----------------------------------------------------------

    def arm(self, *specs: FaultSpec) -> None:
        with self._mu:
            self._specs.extend(specs)

    def disarm(self, point: str | None = None) -> None:
        with self._mu:
            if point is None:
                self._specs = []
            else:
                self._specs = [s for s in self._specs if s.point != point]

    def seed(self, n: int) -> None:
        with self._mu:
            self._rng.seed(n)
            self.log.clear()
            for s in self._specs:
                s.passes = 0
                s.fired = 0

    def _maybe_load_env(self) -> None:
        if self._env_checked:
            return
        self._env_checked = True
        raw = os.environ.get("KUBEINFER_FAULTS", "")
        if not raw:
            return
        self._rng.seed(int(os.environ.get("KUBEINFER_FAULT_SEED", "0")))
        for part in raw.split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            spec = FaultSpec(point=bits[0], mode=bits[1])
            if len(bits) > 2:
                for kv in bits[2].split(","):
                    k, _, v = kv.partition("=")
                    if k in ("rate", "delay_s"):
                        setattr(spec, k, float(v))
                    elif k in ("count", "after"):
                        setattr(spec, k, int(v))
                    else:
                        setattr(spec, k, v)
            self._specs.append(spec)

    # -- firing -----------------------------------------------------------

    def _select(self, point: str, key: str, modes: tuple[str, ...]):
        # caller holds _mu
        for s in self._specs:
            if s.point != point or s.mode not in modes:
                continue
            if s.match and s.match not in key:
                continue
            s.passes += 1
            if s.passes <= s.after:
                continue
            if s.count >= 0 and s.fired >= s.count:
                continue
            if s.rate < 1.0 and self._rng.random() >= s.rate:
                continue
            s.fired += 1
            self.log.append((point, s.mode, key))
            fault_injections_total.inc(point, s.mode)
            return s
        return None

    def fire(self, point: str, key: str = "") -> None:
        """Action faults (error/latency/blackhole) at a control edge."""
        # every control edge is an interleaving opportunity for the
        # schedule fuzzer, armed or not — no-op outside a fuzz run
        if not self._specs and self._env_checked:
            return
        with self._mu:
            self._maybe_load_env()
            s = self._select(point, key, ("error", "latency", "blackhole"))
        if s is None:
            return
        # activation event on whatever span is live at the edge (the
        # store client span, a heartbeat span, ...) — chaos-run traces
        # show WHERE each injection landed; outside the lock like the
        # sleeps below
        tracing.add_event("fault", point=point, mode=s.mode, key=key)
        # sleep OUTSIDE the lock: concurrent edges must not serialize on
        # an injected latency
        if s.mode == "latency":
            time.sleep(s.delay_s)
            return
        if s.mode == "blackhole":
            time.sleep(s.delay_s)
            raise TimeoutError(f"injected blackhole at {point}")
        raise _make_error(s.kind)

    def mangle(self, point: str, data: bytes, key: str = "") -> bytes:
        """Corrupt-payload faults at a data edge; returns ``data``
        (possibly truncated/flipped — deterministic under the seed)."""
        if not self._specs and self._env_checked:
            return data
        with self._mu:
            self._maybe_load_env()
            s = self._select(point, key, ("corrupt",))
            if s is None or not data:
                return data
            # truncate at a seeded offset and flip the last byte: breaks
            # JSON/Content-Length framing without ever being a no-op
            cut = self._rng.randrange(len(data)) if len(data) > 1 else 1
            out = bytearray(data[:max(1, cut)])
            out[-1] ^= 0xFF
        tracing.add_event("fault", point=point, mode="corrupt", key=key)
        return bytes(out)


REGISTRY = FaultRegistry()


def fire(point: str, key: str = "") -> None:
    REGISTRY.fire(point, key)


def mangle(point: str, data: bytes, key: str = "") -> bytes:
    return REGISTRY.mangle(point, data, key)
