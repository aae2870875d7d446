"""Seeded open-loop load generation: arrival processes x length families.

The fleet envelope (docs/OBSERVABILITY.md) needs traffic that looks
like production — bursty arrivals, heavy-tail prompt lengths, shared
prefixes — but replays byte-identically, because a capacity knee that
moves with the harness's RNG is not a measurement. The reference
operator has nothing at this level (its tests drive single requests at
controllers, llmservice_controller.go:66-174 never models load); this
module is the schedfuzz discipline applied to traffic instead of
scheduler interleavings: ONE seed determines every arrival time, every
family draw, every prompt token, and a sha256 checksum over the
canonical schedule pins it cross-process.

Two halves, deliberately separable:

- **Schedule construction** (:func:`make_schedule`) is pure numpy on a
  ``default_rng(seed)`` — no clocks, no threads, no jax — so building
  an O(10^5)-request schedule costs milliseconds and tests can assert
  byte-identity without touching an engine.
- **Open-loop replay** (:func:`replay`) paces the schedule against a
  caller-supplied ``post`` callable (the real ``RouterServer.forward``
  in the fleet benches). Open-loop means arrivals NEVER wait for
  completions — the whole point of an envelope is to observe the system
  past its knee, and a closed loop self-throttles exactly there. Each
  request runs under a fresh client root span, so every hop it takes
  through the fleet (router route -> prefill -> KV stream -> decode)
  joins one trace id and fleetview can assemble per-request ledgers.

Arrival processes (all with the same mean ``rate``):

- ``poisson``: memoryless baseline — iid exponential inter-arrivals.
- ``diurnal``: sinusoidal rate modulation (period ``diurnal_period_s``,
  peak ``1 + diurnal_depth`` over the mean) via Lewis-Shedler thinning;
  the day/night cycle compressed to bench scale.
- ``burst``: on/off traffic — arrivals only inside the duty window of
  each ``burst_period_s`` cycle, at ``rate / burst_duty`` while on. The
  storm-admission case, sustained.

Length families are the heavy-tail pair of bench.py's
serving_slo_bench: longs draw 480/496/512-token prompts, shorts draw
8..16, mixed by ``long_frac``. Prompts share per-group prefixes so the
router's content-addressed affinity has something real to route on.

A copy of ``kubeinfer_tpu/observability/loadgen.py`` for the PyTorch
port: pure numpy on ``default_rng(seed)`` plus the port's ``tracing``,
so its schedules, and their checksums, are byte-identical to the
reference's.
"""

from __future__ import annotations

import hashlib
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np

from kubeinfer_tpu_torch.observability import tracing

__all__ = [
    "PROCESSES",
    "ArrivalSchedule",
    "ReplayRecord",
    "ReplayResult",
    "ScheduledRequest",
    "make_schedule",
    "replay",
]

PROCESSES = ("poisson", "diurnal", "burst")

# the heavy-tail families of serving_slo_bench: near-boundary longs
# keep prefill compute comparable across runs while varying enough that
# the radix trie sees distinct prefixes; shorts are one block
_LONG_LENS = (480, 496, 512)
_SHORT_LO, _SHORT_HI = 8, 17  # rng.integers half-open, so 8..16

# tokens of each prompt drawn from the request's (seed, group) stream
# instead of its private one: half the prompt, capped at two 32-token
# blocks — longs share fingerprintable prefixes within a group, shorts
# stay sub-block (no fingerprint, like real interactive traffic)
_PREFIX_CAP = 64


@dataclass(frozen=True)
class ScheduledRequest:
    """One arrival, fully determined at schedule-build time. Tokens are
    NOT stored — 10^5 requests x 512 tokens would dominate memory — but
    ``prompt_seed``/``group`` determine them exactly
    (:meth:`ArrivalSchedule.prompt_tokens`)."""

    index: int
    t: float  # arrival offset from schedule start, seconds
    family: str  # "long" | "short"
    prompt_len: int
    max_new: int
    group: int  # prefix-sharing cohort
    prompt_seed: int

    def canonical(self) -> str:
        """One checksum line. 9 decimal places on the arrival offset:
        float64 survives a round-trip at that precision for any bench-
        scale offset, so equal schedules hash equal and unequal ones
        differ in the text itself (greppable when a pin breaks)."""
        return (
            f"{self.t:.9f},{self.family},{self.prompt_len},"
            f"{self.max_new},{self.group},{self.prompt_seed}"
        )


@dataclass(frozen=True)
class ArrivalSchedule:
    """An immutable arrival schedule plus the knobs that built it (kept
    so the checksum covers intent, not just outcome — two processes can
    emit the same arrival times and must still hash apart)."""

    process: str
    seed: int
    rate: float  # mean offered req/s
    requests: tuple[ScheduledRequest, ...]

    def duration_s(self) -> float:
        return self.requests[-1].t if self.requests else 0.0

    def offered_req_per_s(self) -> float:
        d = self.duration_s()
        return len(self.requests) / d if d > 0 else 0.0

    def checksum(self) -> str:
        h = hashlib.sha256()
        h.update(
            f"{self.process},{self.seed},{self.rate:.9f},"
            f"{len(self.requests)}\n".encode()
        )
        for r in self.requests:
            h.update(r.canonical().encode())
            h.update(b"\n")
        return h.hexdigest()

    def prompt_tokens(self, r: ScheduledRequest,
                      vocab_size: int) -> list[int]:
        """Materialize one request's prompt ids. Group prefix first,
        private tail second, each from its own ``default_rng`` — so a
        replay (or a retry) regenerates the identical prompt without
        the schedule having stored it."""
        prefix_len = min(r.prompt_len // 2, _PREFIX_CAP)
        pre = np.random.default_rng([self.seed, r.group]).integers(
            0, vocab_size, prefix_len
        )
        tail = np.random.default_rng(r.prompt_seed).integers(
            0, vocab_size, r.prompt_len - prefix_len
        )
        return pre.tolist() + tail.tolist()


def _poisson_arrivals(rng: np.random.Generator, rate: float,
                      n: int) -> np.ndarray:
    return np.cumsum(rng.exponential(1.0 / rate, n))


def _diurnal_arrivals(rng: np.random.Generator, rate: float, n: int,
                      depth: float, period_s: float) -> np.ndarray:
    """Lewis-Shedler thinning against the peak rate, chunked so the
    draw count stays a pure function of (seed, params) — the Python-
    loop version would be too, but at 10^5 arrivals the vector form is
    what keeps schedule construction off the bench clock."""
    peak = rate * (1.0 + depth)
    times: list[float] = []
    t = 0.0
    while len(times) < n:
        m = max(1024, 2 * (n - len(times)))
        cand = t + np.cumsum(rng.exponential(1.0 / peak, m))
        lam = rate * (1.0 + depth * np.sin(
            2.0 * np.pi * cand / period_s
        ))
        keep = rng.random(m) * peak <= lam
        times.extend(cand[keep].tolist())
        t = float(cand[-1])
    return np.asarray(times[:n])


def _burst_arrivals(rng: np.random.Generator, rate: float, n: int,
                    duty: float, period_s: float) -> np.ndarray:
    """On/off: draw Poisson arrivals in 'active time' at the on-rate
    (``rate / duty``), then splice the off windows back in — exact, no
    rejection, and the mean over whole cycles is ``rate`` by
    construction."""
    on_s = period_s * duty
    active = np.cumsum(rng.exponential(duty / rate, n))
    return np.floor(active / on_s) * period_s + np.mod(active, on_s)


def make_schedule(
    process: str = "poisson",
    rate: float = 10.0,
    n_requests: int = 1000,
    seed: int = 0,
    long_frac: float = 0.2,
    long_new: int = 64,
    short_new: int = 4,
    n_groups: int = 8,
    diurnal_depth: float = 0.5,
    diurnal_period_s: float = 60.0,
    burst_duty: float = 0.25,
    burst_period_s: float = 10.0,
) -> ArrivalSchedule:
    """Build one deterministic schedule. Every random draw comes from
    ONE ``default_rng(seed)`` in a fixed order (arrival times, then the
    per-request family/length/group/seed planes), so same seed =>
    byte-identical schedule — the property the determinism tests and
    the cross-process golden checksum pin."""
    if process not in PROCESSES:
        raise ValueError(
            f"unknown arrival process {process!r} (want one of "
            f"{PROCESSES})"
        )
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if not (0.0 <= long_frac <= 1.0):
        raise ValueError(f"long_frac must be in [0, 1], got {long_frac}")
    rng = np.random.default_rng(seed)
    if process == "poisson":
        times = _poisson_arrivals(rng, rate, n_requests)
    elif process == "diurnal":
        times = _diurnal_arrivals(
            rng, rate, n_requests, diurnal_depth, diurnal_period_s
        )
    else:
        times = _burst_arrivals(
            rng, rate, n_requests, burst_duty, burst_period_s
        )
    # whole planes drawn at once (not per request) so construction is
    # vectorized; the order of the five draws is part of the format —
    # reordering them silently breaks every pinned checksum
    is_long = rng.random(n_requests) < long_frac
    long_lens = rng.choice(np.asarray(_LONG_LENS), size=n_requests)
    short_lens = rng.integers(_SHORT_LO, _SHORT_HI, size=n_requests)
    groups = rng.integers(0, n_groups, size=n_requests)
    prompt_seeds = rng.integers(0, 2**31 - 1, size=n_requests)
    reqs = tuple(
        ScheduledRequest(
            index=i,
            t=float(times[i]),
            family="long" if is_long[i] else "short",
            prompt_len=int(long_lens[i] if is_long[i] else short_lens[i]),
            max_new=int(long_new if is_long[i] else short_new),
            group=int(groups[i]),
            prompt_seed=int(prompt_seeds[i]),
        )
        for i in range(n_requests)
    )
    return ArrivalSchedule(
        process=process, seed=seed, rate=rate, requests=reqs,
    )


# --- open-loop replay ------------------------------------------------------


@dataclass
class ReplayRecord:
    """What the client observed for one scheduled request."""

    index: int
    family: str
    trace_id: str
    t_sched: float  # scheduled arrival offset
    t_sent: float  # tracing-clock send time
    t_done: float  # tracing-clock completion (or failure) time
    ok: bool
    error: str | None = None
    ttft_ms: float | None = None  # server-reported (kubeinfer ext)
    tpot_ms: float | None = None
    replica: str | None = None
    tokens_out: int = 0


@dataclass
class ReplayResult:
    records: list[ReplayRecord]
    duration_s: float  # first dispatch to last completion, wall
    late_dispatches: int  # arrivals the pacer could not issue on time

    def completed(self) -> list[ReplayRecord]:
        return [r for r in self.records if r.ok]

    def errors(self) -> int:
        return sum(1 for r in self.records if not r.ok)

    def ttft_ms_percentile(self, q: float) -> float:
        ttfts = [r.ttft_ms for r in self.completed()
                 if r.ttft_ms is not None]
        if not ttfts:
            return float("nan")
        return float(np.percentile(np.asarray(ttfts), q))

    def goodput_tokens_per_s(self) -> float:
        if self.duration_s <= 0:
            return 0.0
        return sum(r.tokens_out for r in self.completed()) / self.duration_s


def replay(
    schedule: ArrivalSchedule,
    post: Callable[[dict], dict],
    vocab_size: int,
    *,
    speed: float = 1.0,
    max_workers: int = 32,
    request_extra: dict | None = None,
    on_dispatch: Callable[[], None] | None = None,
) -> ReplayResult:
    """Replay ``schedule`` open-loop against ``post``.

    ``post`` takes an OpenAI-ish completion body and returns the
    response dict (raising on failure) — the fleet benches pass a thin
    wrapper over ``RouterServer.forward``. ``speed`` compresses the
    schedule's time axis (2.0 = twice as fast); pacing uses the wall
    clock because the engines under test do. The worker pool bounds
    in-flight client threads, NOT the offered load: when every worker
    is busy, dispatches queue inside the executor and the records count
    as late — visible in the result rather than silently converting the
    run to closed-loop. Server-side TTFT/TPOT come from the
    ``kubeinfer`` response extension, so client queueing never pollutes
    the latency the envelope curves report.

    Every request runs under a fresh ``client.request`` root span;
    driving ``RouterServer.forward`` on the worker thread makes the
    router's spans children of it, which is the join fleetview's
    ledgers key on.
    """
    if speed <= 0:
        raise ValueError(f"speed must be > 0, got {speed}")
    tracer = tracing.get_tracer("client")
    records: list[ReplayRecord | None] = [None] * len(schedule.requests)

    def _one(r: ScheduledRequest) -> None:
        body = {
            "prompt": schedule.prompt_tokens(r, vocab_size),
            "max_tokens": r.max_new,
        }
        if request_extra:
            body.update(request_extra)
        with tracer.span("client.request", index=r.index,
                         family=r.family) as sp:
            t_sent = tracing.now()
            rec = ReplayRecord(
                index=r.index, family=r.family,
                trace_id=sp.trace_id, t_sched=r.t,
                t_sent=t_sent, t_done=t_sent, ok=False,
            )
            try:
                resp = post(body)
                ext = resp.get("kubeinfer") or {}
                usage = resp.get("usage") or {}
                rec.ok = True
                rec.ttft_ms = ext.get("ttft_ms")
                rec.tpot_ms = ext.get("tpot_ms")
                rec.replica = ext.get("replica")
                rec.tokens_out = int(usage.get("completion_tokens", 0))
            except Exception as e:
                # the envelope MUST survive past the knee — overload
                # errors are data points, not run failures
                rec.error = f"{type(e).__name__}: {e}"
                sp.set(error=type(e).__name__)
            rec.t_done = tracing.now()
        records[r.index] = rec

    late = 0
    t_wall0 = time.monotonic()
    with ThreadPoolExecutor(
        max_workers=max_workers, thread_name_prefix="loadgen",
    ) as pool:
        futs = []
        for r in schedule.requests:
            target = t_wall0 + r.t / speed
            delay = target - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            else:
                late += 1
            futs.append(pool.submit(_one, r))
            if on_dispatch is not None:
                on_dispatch()
        for f in futs:
            f.result()
    duration = time.monotonic() - t_wall0
    done = [rec for rec in records if rec is not None]
    return ReplayResult(
        records=done, duration_s=duration, late_dispatches=late,
    )
