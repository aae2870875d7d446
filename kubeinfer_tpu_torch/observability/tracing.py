"""In-process distributed tracing: spans, W3C trace context, ring recorder.

The reference operator has no request-scoped tracing at all (its
observability is the coarse Prometheus counters mirrored in
``metrics/registry.py``, pkg/metrics/metrics.go:27-146); this layer is
new mechanism, motivated by the serving path: one completion crosses
manager -> store -> node-agent -> engine with retries and fault
injection in between, and only a shared trace id can say which hop the
latency lived in.

Design constraints, in order:

- **No heavy deps.** No OpenTelemetry SDK in the image, so the span
  model is hand-rolled: 128-bit trace id / 64-bit span id, parent
  links, timed events, all hex-encoded exactly as W3C ``traceparent``
  wants them, so the wire format IS the standard one and a future OTLP
  exporter only needs a translator.
- **Import leaf.** This module imports only ``utils.clock`` and the
  lock factories — never metrics, resilience, or httpbase — so every
  other layer (including those two) can import it without cycles.
- **Deterministic under test.** All timestamps come from a ``Clock``;
  tests swap in ``SimulatedClock`` via :func:`set_clock` (or a
  per-tracer clock) and get bit-stable span timings.
- **Bounded memory.** Spans land in a fixed-capacity ring
  (:class:`SpanRecorder`); a serving process under load overwrites old
  traces instead of growing.
- **Cheap when idle.** ``add_event`` and ``current_context`` are a
  thread-local list peek; no span active means no allocation.

Span ids use ``os.urandom`` rather than ``random`` so tracing never
perturbs the seeded RNG streams the fault-injection registry and the
samplers rely on.

A copy of ``kubeinfer_tpu/observability/tracing.py`` for the PyTorch
port. Its locks are plain ``threading`` primitives: the reference's
race-checker hooks are no-ops outside an armed analysis run, and the
race checker is not ported.
"""

from __future__ import annotations

import collections
import logging
import os
import re
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Iterator

from kubeinfer_tpu_torch.utils.clock import Clock, RealClock

__all__ = [
    "SpanContext",
    "Span",
    "SpanRecorder",
    "Tracer",
    "TraceContextFilter",
    "RECORDER",
    "add_event",
    "current_context",
    "current_span",
    "get_tracer",
    "new_root_context",
    "now",
    "parse_traceparent",
    "set_clock",
    "set_span_sampling",
    "span_sampling",
    "to_chrome_trace",
    "trace_sampled",
]


# --- trace context ---------------------------------------------------------


_TRACEPARENT_RE = re.compile(
    r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$"
)


@dataclass(frozen=True)
class SpanContext:
    """The propagated identity of a span: what crosses process/hop
    boundaries (W3C trace-context `traceparent`, version 00)."""

    trace_id: str  # 32 lowercase hex chars
    span_id: str  # 16 lowercase hex chars

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"


def parse_traceparent(header: str | None) -> SpanContext | None:
    """Parse a ``traceparent`` header; malformed or all-zero ids yield
    None (the spec says an invalid header restarts the trace rather
    than poisoning it)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return SpanContext(trace_id, span_id)


def _new_trace_id() -> str:
    return os.urandom(16).hex()


def _new_span_id() -> str:
    return os.urandom(8).hex()


def new_root_context() -> SpanContext:
    """Fresh trace anchor for work with no inbound context (direct
    ``submit()`` callers, bench runs): children parented to it still
    group under one trace id even though the anchor span itself is
    never recorded."""
    return SpanContext(_new_trace_id(), _new_span_id())


# --- clock indirection -----------------------------------------------------

# module default used by every tracer without an explicit clock;
# swapped wholesale by tests (never mutated concurrently with reads
# that care — a mid-test swap only skews timestamps, never crashes)
_default_clock: Clock = RealClock()


def set_clock(clock: Clock) -> Clock:
    """Install ``clock`` as the default tracing clock; returns the
    previous one so tests can restore it."""
    global _default_clock
    prev = _default_clock
    _default_clock = clock
    return prev


def now() -> float:
    """Current tracing time (seconds). The one timestamp source for
    span start/end and the instrumented request timelines, so
    simulated-clock tests see a single coherent timeline."""
    return _default_clock.now()


# --- head sampling ---------------------------------------------------------

# Keep-1-in-N switch applied at the single record point
# (:meth:`Tracer.finish`). The decision is a pure function of the trace
# id, NOT a counter or RNG draw: every hop of a distributed request
# (router, prefill replica, decode replica) hashes the same propagated
# trace id to the same verdict, so a sampled-in trace keeps ALL its
# spans and a sampled-out one keeps none — ledgers stay whole or absent,
# never partial. Sampled-out requests still count in metrics: the
# histograms and SLO monitors read the request timeline fields
# (t_submit/t_admit/t_first/t_done), which this switch never touches.
_sample_every: int = 1


def set_span_sampling(n: int) -> int:
    """Keep one trace in ``n`` (1 = keep everything, the default);
    returns the previous setting so callers can restore it."""
    global _sample_every
    if n < 1:
        raise ValueError(f"span sampling must be >= 1, got {n}")
    prev = _sample_every
    _sample_every = n
    return prev


def span_sampling() -> int:
    return _sample_every


def trace_sampled(trace_id: str, n: int | None = None) -> bool:
    """Deterministic keep/drop verdict for a trace id. The low 32 bits
    of the (uniformly random) id are as good a hash as any; a malformed
    id is kept so a bad inbound header degrades to over-recording, not
    a silent ledger hole."""
    n = _sample_every if n is None else n
    if n <= 1:
        return True
    try:
        return int(trace_id[-8:], 16) % n == 0
    except ValueError:
        return True


# --- spans -----------------------------------------------------------------


class Span:
    """One timed operation. Mutable until ended; recorded exactly once.

    Not thread-safe by design: a span belongs to the thread (or the
    single scheduler owner) that created it. Cross-thread causality is
    expressed by passing the span's ``context`` as another span's
    parent, never by sharing the Span object.
    """

    __slots__ = (
        "name", "component", "trace_id", "span_id", "parent_id",
        "start", "end", "attrs", "events",
    )

    def __init__(self, name: str, component: str, trace_id: str,
                 span_id: str, parent_id: str | None, start: float,
                 attrs: dict | None = None) -> None:
        self.name = name
        self.component = component
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end: float | None = None
        self.attrs: dict = dict(attrs) if attrs else {}
        self.events: list[tuple[float, str, dict]] = []

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def event(self, name: str, ts: float | None = None, **attrs) -> None:
        self.events.append((now() if ts is None else ts, name, attrs))

    def duration(self) -> float:
        return (self.end if self.end is not None else self.start) - self.start

    def __repr__(self) -> str:  # debugging aid only
        return (
            f"Span({self.name!r}, component={self.component!r}, "
            f"trace={self.trace_id[:8]}.., span={self.span_id}, "
            f"parent={self.parent_id}, dur={self.duration():.6f})"
        )


class SpanRecorder:
    """Fixed-capacity ring of ended spans.

    The capacity bounds memory under sustained traffic; readers get
    snapshots (copies) so export never races recording.
    """

    def __init__(self, capacity: int = 8192,
                 name: str = "observability.SpanRecorder._lock") -> None:
        self._lock = threading.Lock()
        self._spans: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )

    def record(self, span: Span) -> None:
        with self._lock:
            self._spans.append(span)

    def snapshot(self, trace_id: str | None = None) -> list[Span]:
        with self._lock:
            spans = list(self._spans)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)

    def to_chrome_trace(self, trace_id: str | None = None) -> dict:
        return to_chrome_trace(self.snapshot(trace_id))


RECORDER = SpanRecorder()


# --- thread-local active-span stack ---------------------------------------

# plain threading.local: per-thread state needs no lock by construction
_tls = threading.local()


def _stack() -> list[Span]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_span() -> Span | None:
    st = _stack()
    return st[-1] if st else None


def current_context() -> SpanContext | None:
    sp = current_span()
    return sp.context if sp is not None else None


def add_event(name: str, **attrs) -> None:
    """Attach a timed event to the innermost active span of THIS
    thread; silently a no-op when none is active — instrumentation
    sites (retry loops, fault points) call this unconditionally."""
    sp = current_span()
    if sp is not None:
        sp.event(name, **attrs)


# --- tracer ----------------------------------------------------------------


class Tracer:
    """Factory for spans of one component.

    ``recorder``/``clock`` default to the module globals *at call
    time*, so tests that install a SimulatedClock via :func:`set_clock`
    affect tracers created before the swap too.
    """

    def __init__(self, component: str, recorder: SpanRecorder | None = None,
                 clock: Clock | None = None) -> None:
        self.component = component
        self._recorder = recorder
        self._clock = clock

    def _now(self) -> float:
        return (self._clock or _default_clock).now()

    def _rec(self) -> SpanRecorder:
        return self._recorder if self._recorder is not None else RECORDER

    def start_span(self, name: str, parent: SpanContext | None = None,
                   start: float | None = None, **attrs) -> Span:
        """Create (but do not activate or record) a span. ``parent``
        None means: the thread's current span if any, else a new root."""
        if parent is None:
            parent = current_context()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = _new_trace_id(), None
        return Span(
            name, self.component, trace_id, _new_span_id(), parent_id,
            self._now() if start is None else start, attrs,
        )

    def finish(self, span: Span, end: float | None = None) -> Span:
        # THE single record point — both span() and record_span() land
        # here, so the head-sampling gate lives here and nowhere else.
        # The span is still ended and returned either way: callers that
        # read timings/attrs off the return see no difference.
        span.end = self._now() if end is None else end
        if trace_sampled(span.trace_id):
            self._rec().record(span)
        return span

    def record_span(self, name: str, start: float, end: float,
                    parent: SpanContext | None = None, **attrs) -> Span:
        """Record a span retroactively from timestamps captured
        elsewhere — how the batcher turns its request timeline
        (submit/admit/first-token/done) into queue-wait/prefill/decode
        spans without holding a live span across scheduler passes."""
        span = self.start_span(name, parent=parent, start=start, **attrs)
        return self.finish(span, end=end)

    @contextmanager
    def span(self, name: str, parent: SpanContext | None = None,
             **attrs) -> Iterator[Span]:
        """Run a block under an active span: pushed on the thread's
        stack (so nested spans and ``add_event`` parent correctly),
        error-annotated on exception, always ended and recorded."""
        sp = self.start_span(name, parent=parent, **attrs)
        st = _stack()
        st.append(sp)
        try:
            yield sp
        except BaseException as e:
            sp.set(error=type(e).__name__)
            raise
        finally:
            if st and st[-1] is sp:
                st.pop()
            else:  # defensive: unbalanced exit must not corrupt siblings
                try:
                    st.remove(sp)
                except ValueError:
                    pass
            self.finish(sp)


def get_tracer(component: str) -> Tracer:
    return Tracer(component)


# --- exporters -------------------------------------------------------------


def to_chrome_trace(spans: list[Span]) -> dict:
    """Render spans as Chrome trace-event JSON (the format under
    ``docs/traces/``, loadable in Perfetto / chrome://tracing).

    Mapping: component -> pid (named via ``M`` metadata events), trace
    -> tid (so one request's spans share a row, named ``trace <id..>``
    via ``thread_name`` metadata — Perfetto then labels every row by
    component/trace instead of raw integers), span -> ``X`` complete
    event, span event -> ``i`` instant. Times are microseconds as the
    format requires; trace/span/parent ids ride in ``args`` so the
    causal links survive the conversion.
    """
    components = sorted({s.component for s in spans})
    pid_of = {c: i + 1 for i, c in enumerate(components)}
    tids: dict[str, int] = {}
    events: list[dict] = []
    for c in components:
        events.append({
            "ph": "M", "name": "process_name", "pid": pid_of[c], "tid": 0,
            "args": {"name": c},
        })
    # (pid, tid) -> trace id: one thread_name metadata event per row a
    # component actually uses (tids are shared across components so one
    # trace aligns horizontally across process groups)
    rows: dict[tuple[int, int], str] = {}
    for s in spans:
        tid = tids.setdefault(s.trace_id, len(tids) + 1)
        pid = pid_of[s.component]
        rows.setdefault((pid, tid), s.trace_id)
        end = s.end if s.end is not None else s.start
        args = {
            "trace_id": s.trace_id,
            "span_id": s.span_id,
            "parent_id": s.parent_id or "",
        }
        args.update({k: v for k, v in s.attrs.items()})
        events.append({
            "ph": "X", "name": s.name, "cat": s.component,
            "pid": pid, "tid": tid,
            "ts": s.start * 1e6, "dur": max(0.0, (end - s.start) * 1e6),
            "args": args,
        })
        for ts, name, attrs in s.events:
            events.append({
                "ph": "i", "s": "t", "name": name, "cat": s.component,
                "pid": pid, "tid": tid, "ts": ts * 1e6,
                "args": dict(attrs),
            })
    for (pid, tid), trace_id in sorted(rows.items()):
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
            "args": {"name": f"trace {trace_id[:8]}"},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# --- logging correlation ---------------------------------------------------


class TraceContextFilter(logging.Filter):
    """Stamps every record with the emitting thread's ``trace_id`` (or
    ``-``), so a format string like ``%(trace_id)s %(message)s``
    correlates log lines with the trace that produced them. A Filter
    rather than an Adapter so one ``addFilter`` covers a whole handler
    regardless of which logger emitted."""

    def filter(self, record: logging.LogRecord) -> bool:
        ctx = current_context()
        record.trace_id = ctx.trace_id if ctx is not None else "-"
        return True
