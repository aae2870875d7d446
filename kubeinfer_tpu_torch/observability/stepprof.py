"""Step-level engine profiler: one fixed-size record per device dispatch.

The span layer (tracing.py) answers "where did THIS request's latency
go"; this module answers "what was the ENGINE doing" — how full each
batched dispatch was, how many padded tokens the bucketing burned, and
whether a step paid a first-dispatch-of-shape compile. The reference
operator has nothing at this level (vLLM keeps the equivalent inside
its scheduler, vllm.go:93-112 only proxies the process); our engine
owns the step loop, so it can be first-class.

Design constraints, matching tracing.py:

- **Clock discipline.** Callers stamp start/end with ``tracing.now()``
  (the one timestamp source), so SimulatedClock tests get bit-stable
  goodput/occupancy numbers.
- **Plain bounded ring.** A ``deque(maxlen=...)`` of frozen records —
  no ``os.urandom``, no ids — so profiling never perturbs the seeded
  RNG streams the samplers and the fault registry rely on, and memory
  is bounded under sustained traffic.
- **Cheap on the hot path.** ``record()`` is a tuple build + deque
  append under a lock; the KV pool (which takes its own lock) is only
  *sampled* every ``kv_sample_every`` records, with the last sample
  carried forward in between.

Readers (the /metrics scrape, ``stats_summary()``, bench) pull
snapshots; the monotonic ``seq`` lets a scraper replay only the records
it has not yet folded into its histograms.

A copy of ``kubeinfer_tpu/observability/stepprof.py`` for the PyTorch
port. Its lock is a plain ``threading.Lock`` (the reference's
race-checker factory is a no-op outside an armed analysis run, and the
race checker is not ported); ``name`` is kept for signature parity.
``compiled`` keeps the reference's rule, the first record of each
(phase, bucket). In the port nothing is traced or compiled per shape:
that record is the shape's first launch, where a kernel's first-use
build and the CUDA caching allocator's first growth for that shape
land.
"""

from __future__ import annotations

import collections
import threading
from dataclasses import dataclass

from kubeinfer_tpu_torch.observability import tracing

__all__ = ["StepRecord", "StepProfiler"]

PHASES = ("prefill", "decode", "spec", "chunk")


@dataclass(frozen=True)
class StepRecord:
    """One device dispatch, as the scheduler saw it."""

    seq: int  # monotonic dispatch index (scrape cursors key on it)
    t: float  # dispatch end, tracing-clock seconds
    phase: str  # "prefill" | "decode" | "spec" | "chunk"
    bucket: int  # compiled-shape knob: suffix bucket / batch width
    live_rows: int  # rows carrying a real request
    n_slots: int  # batch capacity the dispatch was padded to
    live_tokens: int  # tokens that reached a request this step
    padded_tokens: int  # tokens computed for padding only
    dur_s: float  # step wall time (end - start)
    compiled: bool  # first dispatch of (phase, bucket) on this profiler
    kv_in_use: int  # sampled pool blocks referenced (-1 = not sampled)
    kv_free: int  # sampled pool free-list size (-1 = not sampled)
    # model steps fused into this ONE dispatch (decode windows: K; every
    # other phase: 1). dur_s brackets the whole window, so per-step time
    # is dur_s / steps and per-token timestamps inside the bracket are
    # interpolated (docs/OBSERVABILITY.md). Defaulted so records built
    # by older callers/tests keep their shape.
    steps: int = 1

    def occupancy(self) -> float:
        return self.live_rows / max(1, self.n_slots)

    def padding_waste(self) -> float:
        total = self.live_tokens + self.padded_tokens
        return self.padded_tokens / total if total else 0.0

    def to_dict(self) -> dict:
        return {
            "seq": self.seq, "t": self.t, "phase": self.phase,
            "bucket": self.bucket, "live_rows": self.live_rows,
            "n_slots": self.n_slots, "live_tokens": self.live_tokens,
            "padded_tokens": self.padded_tokens, "dur_s": self.dur_s,
            "compiled": self.compiled, "kv_in_use": self.kv_in_use,
            "kv_free": self.kv_free, "steps": self.steps,
        }


class StepProfiler:
    """Fixed-capacity ring of :class:`StepRecord`.

    ``kv_stats`` is an optional ``() -> (in_use, free)`` callback
    (ContinuousEngine wires the block pool's counters). It is invoked
    OUTSIDE this profiler's lock so the lock order stays acyclic with
    the pool's own lock (docs/ARCHITECTURE.md lock-order table).
    """

    def __init__(self, n_slots: int, capacity: int = 2048,
                 kv_sample_every: int = 8, kv_stats=None,
                 name: str = "observability.StepProfiler._lock") -> None:
        self.n_slots = n_slots
        self._kv_stats = kv_stats
        self._kv_sample_every = max(1, kv_sample_every)
        self.name = name
        self._lock = threading.Lock()
        self._ring: collections.deque[StepRecord] = collections.deque(
            maxlen=capacity
        )
        self._seq = 0
        self._seen_shapes: set[tuple[str, int]] = set()
        self._compile_count = 0
        self._last_kv = (-1, -1)

    # -- writer (scheduler thread) -----------------------------------------

    def record(self, phase: str, bucket: int, live_rows: int,
               live_tokens: int, padded_tokens: int,
               start: float, end: float, steps: int = 1) -> StepRecord:
        """Append one dispatch record; returns it (tests and the flight
        recorder read fields straight off the return)."""
        kv_in_use, kv_free = self._last_kv
        sample = (
            self._kv_stats is not None
            and self._seq % self._kv_sample_every == 0
        )
        if sample:
            kv_in_use, kv_free = self._kv_stats()
        with self._lock:
            shape = (phase, bucket)
            compiled = shape not in self._seen_shapes
            if compiled:
                self._seen_shapes.add(shape)
                self._compile_count += 1
            if sample:
                self._last_kv = (kv_in_use, kv_free)
            rec = StepRecord(
                seq=self._seq, t=end, phase=phase, bucket=bucket,
                live_rows=live_rows, n_slots=self.n_slots,
                live_tokens=live_tokens, padded_tokens=padded_tokens,
                dur_s=max(0.0, end - start), compiled=compiled,
                kv_in_use=kv_in_use, kv_free=kv_free, steps=steps,
            )
            self._seq += 1
            self._ring.append(rec)
        return rec

    # -- readers (any thread) ----------------------------------------------

    @property
    def compile_count(self) -> int:
        with self._lock:
            return self._compile_count

    def snapshot(self, since_seq: int = -1) -> list[StepRecord]:
        """Records with ``seq > since_seq`` (all, by default). The
        /metrics scrape passes its last-seen seq so step-duration
        histogram observations are made exactly once per dispatch."""
        with self._lock:
            return [r for r in self._ring if r.seq > since_seq]

    def summary(self, window_s: float = 60.0,
                now: float | None = None) -> dict:
        """Sliding-window aggregates over records with
        ``t >= now - window_s``.

        goodput = live tokens emitted in the window / window width —
        the serving throughput that excludes padding (the raw step
        count times batch width is what a naive tokens/sec would
        report; the gap between the two IS the waste this profiler
        exists to expose). Occupancy averages over decode steps (the
        steady-state shape); with no decode steps yet it falls back to
        all records so a prefill-only engine still reports something
        truthful.
        """
        now = tracing.now() if now is None else now
        recs = self.snapshot()
        win = [r for r in recs if r.t >= now - window_s]
        live = sum(r.live_tokens for r in win)
        padded = sum(r.padded_tokens for r in win)
        decode = [r for r in win if r.phase == "decode"]
        occ_base = decode or win
        occupancy = (
            sum(r.occupancy() for r in occ_base) / len(occ_base)
            if occ_base else 0.0
        )
        # denominator = fused model steps (per-ROW token positions),
        # not live_tokens: live_tokens scales with batch width, which
        # would make the ratio depend on occupancy. Per-step it is
        # exactly 1.0 for the single-step loop and 1/K for fused
        # windows (0.125 at K=8) at any batch width. bench.py
        # publishes it as decode_dispatches_per_token.
        decode_steps = sum(r.steps for r in decode)
        return {
            "window_s": window_s,
            "steps": len(win),
            "goodput_tokens_per_sec": live / window_s if window_s else 0.0,
            "batch_occupancy": occupancy,
            "padding_waste_frac": padded / max(1, live + padded),
            "compile_count": self.compile_count,
            "decode_dispatches_per_token": (
                len(decode) / decode_steps if decode_steps else 0.0
            ),
        }

    def counter_events(self, pid: int) -> list[dict]:
        """Chrome trace-event ``C`` (counter) samples: Perfetto draws
        one curve per ``name``, sampled at each step's end time —
        occupancy and padded tokens alongside the span timeline."""
        events: list[dict] = []
        for r in self.snapshot():
            ts = r.t * 1e6
            events.append({
                "ph": "C", "name": "batch_occupancy", "pid": pid,
                "tid": 0, "ts": ts,
                "args": {"live_rows": r.live_rows},
            })
            events.append({
                "ph": "C", "name": "padded_tokens", "pid": pid,
                "tid": 0, "ts": ts,
                "args": {"padded": r.padded_tokens},
            })
        return events
