"""Fleet aggregation plane: merged traces, request ledgers, envelopes.

Each replica has deep telemetry — spans, StepProfiler rings,
FlightRecorder decision logs — but every reader of it is per-replica,
and the questions that matter at fleet scale are joins: "where did THIS
request's p99 latency go, across the three replicas it touched?" and
"what is max sustained req/s before the TTFT SLO breaks?". The
reference operator only ever aggregates pod status counts
(llmservice_controller.go:66-174 syncs replica counts, never
request-level capacity); this module is the deliberate divergence.

Three layers, each consuming the one below:

- **Per-replica drains.** :meth:`FleetView.drain` advances an
  exactly-once cursor per registered replica over its StepProfiler and
  FlightRecorder rings (the ``seq > since`` contract both now share),
  accumulating history the bounded rings would overwrite. Rings stay
  small and hot-path-cheap; the fleet view owns the long memory.
- **Request ledgers.** Spans from every replica land in the shared
  :data:`tracing.RECORDER` tagged with a ``replica`` attr; grouping by
  trace id reassembles each request's path. The engine stamps its
  phases contiguously by construction (queue_wait ends at t_admit where
  prefill starts; prefill ends at first-token where decode starts —
  batching.py), so the ledger's breakdown is queue/route/prefill/
  stream/decode plus an explicit ``other`` residual that absorbs
  whatever the instrumented phases do not cover (proxy overhead,
  inter-hop gaps during migration); the six always sum to the ledger's
  end-to-end by construction, which is what makes tail attribution
  mechanical instead of forensic.
- **Envelope analytics.** Offered-load sweep points fold into
  goodput-vs-offered curves and a knee: the highest offered load whose
  p99 TTFT still holds the SLO objective with a bounded error rate.

A copy of ``kubeinfer_tpu/observability/fleetview.py`` for the PyTorch
port: it drains the port's ``StepProfiler`` and ``FlightRecorder`` rings
and joins the port's spans.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Sequence

from kubeinfer_tpu_torch.observability import tracing

__all__ = [
    "PHASES",
    "EnvelopePoint",
    "FleetView",
    "RequestLedger",
    "build_ledgers",
    "detect_knee",
    "envelope_point",
    "tail_attribution",
]

# ledger phases in serving order; "other" is the derived residual, not
# a span name
PHASES = ("queue", "route", "prefill", "stream", "decode")

# span name -> ledger phase. One flat rule set — THE join contract
# documented in docs/OBSERVABILITY.md; a new instrumented phase means a
# new row here and nowhere else.
_PHASE_OF = {
    "engine.queue_wait": "queue",
    "router.route": "route",
    "engine.prefill": "prefill",
    "server.kv_import": "stream",
    "engine.decode": "decode",
}


@dataclass
class RequestLedger:
    """One request's end-to-end accounting, joined across hops by trace
    id. Durations are summed per phase (a migrated request has one
    prefill span per hop); ``other_s`` is the explicit residual so
    ``sum(phases) + other == e2e`` exactly."""

    trace_id: str
    t_start: float
    t_end: float
    phase_s: dict[str, float]
    other_s: float
    # replica attr of each phase's spans, in span start order —
    # "router routed to r1, prefill ran on p0, decode on r1" reads
    # straight off this
    phase_replicas: dict[str, list[str]]
    hops: int  # engine admissions (1 + migration resumes)
    spans: int

    @property
    def e2e_s(self) -> float:
        return self.t_end - self.t_start

    def dominant(self) -> tuple[str, str | None]:
        """(phase, replica) that ate the most time — the tail-cohort
        attribution unit. ``other`` can dominate (it is a finding, not
        a bookkeeping artifact: it means the latency lived outside the
        instrumented phases)."""
        best, best_d = "other", self.other_s
        for ph, d in self.phase_s.items():
            if d > best_d:
                best, best_d = ph, d
        reps = self.phase_replicas.get(best) or []
        return best, (reps[-1] if reps else None)

    def to_dict(self) -> dict:
        phase, replica = self.dominant()
        return {
            "trace_id": self.trace_id,
            "t_start": self.t_start,
            "t_end": self.t_end,
            "e2e_s": self.e2e_s,
            "phases_s": dict(self.phase_s),
            "other_s": self.other_s,
            "phase_replicas": {
                k: list(v) for k, v in self.phase_replicas.items()
            },
            "hops": self.hops,
            "spans": self.spans,
            "dominant_phase": phase,
            "dominant_replica": replica,
        }


def build_ledgers(spans: Sequence[tracing.Span]) -> list[RequestLedger]:
    """Join spans into per-request ledgers by trace id.

    Join rules (docs/OBSERVABILITY.md "Fleet envelope"):

    - a trace yields a ledger iff it contains at least one engine span
      (queue_wait/prefill/decode) — traces that never reached an engine
      (pure routing failures, bench scaffolding) are not requests;
    - the e2e bracket is the trace's ``client.request`` root span when
      present (the loadgen replay always makes one), else the min/max
      extent of the trace's own spans;
    - per-phase time is the SUM of that phase's span durations — a
      migrated request contributes one prefill span per hop, and the
      inter-hop gap lands in ``other`` rather than being hidden;
    - head-sampling keeps or drops whole traces (tracing.py), so every
      ledger built here is complete — there are no partially sampled
      ledgers to mis-rank.
    """
    by_trace: dict[str, list[tracing.Span]] = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    out: list[RequestLedger] = []
    for tid, group in by_trace.items():
        group.sort(key=lambda s: (s.start, s.name))
        engine_spans = [s for s in group
                        if s.name in ("engine.queue_wait",
                                      "engine.prefill", "engine.decode")]
        if not engine_spans:
            continue
        root = next(
            (s for s in group if s.name == "client.request"), None
        )
        phase_s = {ph: 0.0 for ph in PHASES}
        phase_replicas: dict[str, list[str]] = {}
        lo, hi = float("inf"), float("-inf")
        for s in group:
            end = s.end if s.end is not None else s.start
            lo, hi = min(lo, s.start), max(hi, end)
            ph = _PHASE_OF.get(s.name)
            if ph is None:
                continue
            phase_s[ph] += max(0.0, end - s.start)
            rep = s.attrs.get("replica")
            if rep is not None:
                phase_replicas.setdefault(ph, []).append(str(rep))
        if root is not None:
            t0 = root.start
            t1 = root.end if root.end is not None else hi
        else:
            t0, t1 = lo, hi
        e2e = max(0.0, t1 - t0)
        out.append(RequestLedger(
            trace_id=tid, t_start=t0, t_end=t1,
            phase_s=phase_s,
            other_s=max(0.0, e2e - sum(phase_s.values())),
            phase_replicas=phase_replicas,
            hops=max(1, sum(1 for s in group
                            if s.name == "engine.prefill")),
            spans=len(group),
        ))
    out.sort(key=lambda led: led.t_start)
    return out


def tail_attribution(ledgers: Sequence[RequestLedger],
                     q: float = 99.0) -> dict:
    """Who ate the tail: take the ledgers at or above the q-th e2e
    percentile and count dominant (phase, replica) pairs. The answer
    the envelope exists to make mechanical — "p99 is queue time on
    replica r1" — as plain counts, no interpretation layer."""
    if not ledgers:
        return {"cohort": 0, "by_phase": {}, "by_replica": {},
                "e2e_s_cut": None}
    e2es = sorted(led.e2e_s for led in ledgers)
    # nearest-rank percentile: the cut is an observed value, so the
    # cohort is never empty
    k = max(0, min(len(e2es) - 1, int(len(e2es) * q / 100.0)))
    cut = e2es[k]
    cohort = [led for led in ledgers if led.e2e_s >= cut]
    by_phase: dict[str, int] = {}
    by_replica: dict[str, int] = {}
    for led in cohort:
        phase, replica = led.dominant()
        by_phase[phase] = by_phase.get(phase, 0) + 1
        if replica is not None:
            by_replica[replica] = by_replica.get(replica, 0) + 1
    return {
        "cohort": len(cohort),
        "e2e_s_cut": cut,
        "by_phase": dict(sorted(by_phase.items(),
                                key=lambda kv: -kv[1])),
        "by_replica": dict(sorted(by_replica.items(),
                                  key=lambda kv: -kv[1])),
    }


# --- per-replica drains + merged trace -------------------------------------


@dataclass
class _ReplicaSource:
    """One registered replica's accumulated telemetry. The cursors make
    drains exactly-once; the lists are the long memory the bounded
    rings don't keep."""

    name: str
    engine: object  # ContinuousEngine (duck-typed: .profiler, .flight)
    steps: list = field(default_factory=list)
    flights: list = field(default_factory=list)
    _step_seq: int = -1
    _flight_seq: int = -1


class FleetView:
    """Drains per-replica telemetry into one merged view.

    Single-threaded by design: the bench/harness thread that owns the
    sweep calls drain()/ledgers()/merged_chrome_trace(); the replicas'
    own locks protect the rings being read. Registering an engine twice
    under one name replaces the source (fresh engines per sweep point)."""

    def __init__(self, recorder: tracing.SpanRecorder | None = None) -> None:
        self._recorder = recorder if recorder is not None else tracing.RECORDER
        self._sources: dict[str, _ReplicaSource] = {}

    def register(self, name: str, engine) -> None:
        self._sources[name] = _ReplicaSource(name=name, engine=engine)

    def drain(self) -> dict[str, tuple[int, int]]:
        """Pull new step/flight records from every registered replica;
        returns {replica: (new_steps, new_flight_events)}. Called
        periodically during a run (and once after), so ring capacity
        bounds the POLL interval, not the run length."""
        drained: dict[str, tuple[int, int]] = {}
        for name, src in self._sources.items():
            steps = src.engine.profiler.snapshot(since_seq=src._step_seq)
            if steps:
                src._step_seq = steps[-1].seq
                src.steps.extend(steps)
            evs = src.engine.flight.snapshot(since_seq=src._flight_seq)
            if evs:
                src._flight_seq = evs[-1].seq
                src.flights.extend(evs)
            drained[name] = (len(steps), len(evs))
        return drained

    def merged_chrome_trace(
        self, spans: Sequence[tracing.Span] | None = None,
    ) -> dict:
        """One Chrome trace for the whole fleet: spans get per-replica
        process groups (pid = "replica:component", from each span's
        ``replica`` attr), and every registered replica's drained
        step/flight counters render as its own counter track. Open in
        Perfetto: a request's row crosses replica process groups
        exactly where it migrated."""
        spans = self._recorder.snapshot() if spans is None else list(spans)
        relabeled: list[tracing.Span] = []
        for s in spans:
            rep = s.attrs.get("replica")
            if rep is None:
                relabeled.append(s)
                continue
            ns = tracing.Span(
                s.name, f"{rep}:{s.component}", s.trace_id, s.span_id,
                s.parent_id, s.start, s.attrs,
            )
            ns.end = s.end
            ns.events = list(s.events)
            relabeled.append(ns)
        doc = tracing.to_chrome_trace(relabeled)
        pid = max(
            (e.get("pid", 0) for e in doc["traceEvents"]), default=0
        )
        for name in sorted(self._sources):
            src = self._sources[name]
            pid += 1
            doc["traceEvents"].append({
                "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                "args": {"name": f"{name}:counters"},
            })
            for r in src.steps:
                ts = r.t * 1e6
                doc["traceEvents"].append({
                    "ph": "C", "name": "batch_occupancy", "pid": pid,
                    "tid": 0, "ts": ts,
                    "args": {"live_rows": r.live_rows},
                })
            for e in src.flights:
                ts = e.t * 1e6
                doc["traceEvents"].append({
                    "ph": "C", "name": "queue_depth", "pid": pid,
                    "tid": 0, "ts": ts, "args": {"depth": e.queue_depth},
                })
                if e.kv_in_use >= 0:
                    doc["traceEvents"].append({
                        "ph": "C", "name": "kv_blocks", "pid": pid,
                        "tid": 0, "ts": ts,
                        "args": {"in_use": e.kv_in_use,
                                 "free": e.kv_free},
                    })
        return doc

    def ledgers(
        self, spans: Sequence[tracing.Span] | None = None,
    ) -> list[RequestLedger]:
        spans = self._recorder.snapshot() if spans is None else spans
        return build_ledgers(spans)

    def steps(self, name: str) -> list:
        return list(self._sources[name].steps)

    def flights(self, name: str) -> list:
        return list(self._sources[name].flights)


# --- envelope analytics ----------------------------------------------------


@dataclass(frozen=True)
class EnvelopePoint:
    """One offered-load sweep point, as the curve artifact stores it."""

    offered_req_per_s: float
    completed: int
    errors: int
    late_dispatches: int
    goodput_tokens_per_s: float
    ttft_ms_p50: float
    ttft_ms_p99: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def envelope_point(offered_req_per_s: float, result) -> EnvelopePoint:
    """Fold one loadgen ReplayResult into a sweep point. Duck-typed on
    the result's surface (completed()/errors()/ttft_ms_percentile/
    goodput_tokens_per_s) so tests can feed synthetic results."""
    return EnvelopePoint(
        offered_req_per_s=float(offered_req_per_s),
        completed=len(result.completed()),
        errors=int(result.errors()),
        late_dispatches=int(result.late_dispatches),
        goodput_tokens_per_s=float(result.goodput_tokens_per_s()),
        ttft_ms_p50=float(result.ttft_ms_percentile(50.0)),
        ttft_ms_p99=float(result.ttft_ms_percentile(99.0)),
    )


def detect_knee(points: Sequence[EnvelopePoint], slo_ttft_ms: float,
                max_error_frac: float = 0.01) -> EnvelopePoint | None:
    """The knee: the HIGHEST offered load whose p99 TTFT holds the SLO
    objective AND whose error fraction stays bounded (an overloaded
    fleet that sheds its way to a good p99 has not sustained the
    load). Returns None when no sweep point qualifies — the fleet's
    knee is below the sweep's floor, which the caller should report,
    not paper over."""
    knee: EnvelopePoint | None = None
    for p in sorted(points, key=lambda p: p.offered_req_per_s):
        total = p.completed + p.errors
        err_frac = p.errors / total if total else 1.0
        p99 = p.ttft_ms_p99
        if p99 == p99 and p99 <= slo_ttft_ms and \
                err_frac <= max_error_frac:
            knee = p
    return knee
