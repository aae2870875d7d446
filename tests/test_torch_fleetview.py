"""The port's fleet plane (``observability/loadgen.py``,
``observability/fleetview.py``) against the JAX package's, on the CPU.

- ``loadgen``: for each arrival process the schedule's checksum equals
  the reference's ``make_schedule`` and its golden pin
  (``tests/test_observability_loadgen.py``), the prompts equal the
  reference's, and the replay cases of ``TestReplay`` hold.
- ``fleetview``: ``build_ledgers``, ``tail_attribution``,
  ``detect_knee``, ``envelope_point``, ``FleetView``'s exactly-once drain
  and its merged trace equal the reference's on the same span and ring
  contents (``tests/test_observability_envelope.py``), compared as dicts.
  The spans are recorded once through the port's tracer and copied field
  for field into the reference's ``Span``.
- A request routed by the port's ``RouterServer`` to a port tiny server
  joins into one ledger whose phases and residual sum to its end to end.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
from types import SimpleNamespace

import pytest

from kubeinfer_tpu.observability import fleetview as jfv
from kubeinfer_tpu.observability import loadgen as jlg
from kubeinfer_tpu.observability import tracing as jtr
from kubeinfer_tpu_torch.observability import fleetview, loadgen, tracing
from kubeinfer_tpu_torch.observability.tracing import SpanRecorder, Tracer

# tests/test_observability_loadgen.py's cross-process pin:
# make_schedule(proc, rate=10.0, n_requests=50, seed=7)
GOLDEN = {
    "poisson":
        "c8623da30519a32eed9dbb766bfc88f654f1adb357a4d31f3c5f02f91b07ba20",
    "diurnal":
        "dc90e272c7f016c390eef9745d94d30078fb26164a79d16738de807179142140",
    "burst":
        "50fb825cc8ecb7cf23c64fb91ff7147b4f398b59db0ef099680e569c0b7e631c",
}


# --- loadgen ------------------------------------------------------------------


@pytest.mark.parametrize("proc", loadgen.PROCESSES)
def test_schedule_checksum_equals_the_references(proc):
    s = loadgen.make_schedule(proc, rate=10.0, n_requests=50, seed=7)
    assert s.checksum() == GOLDEN[proc]
    kw = dict(rate=12.5, n_requests=300, seed=29, long_frac=0.3,
              long_new=16, short_new=4)
    ours = loadgen.make_schedule(proc, **kw)
    ref = jlg.make_schedule(proc, **kw)
    assert ours.checksum() == ref.checksum()
    assert [dataclasses.asdict(r) for r in ours.requests] == \
        [dataclasses.asdict(r) for r in ref.requests]
    assert ours.offered_req_per_s() == ref.offered_req_per_s()
    for r, q in list(zip(ours.requests, ref.requests))[:20]:
        assert ours.prompt_tokens(r, 1000) == ref.prompt_tokens(q, 1000)


def test_schedule_validation_and_seed_sensitivity():
    for args in (("lunar", 1.0, 1), ("poisson", 0.0, 1), ("poisson", 1.0, 0)):
        with pytest.raises(ValueError):
            loadgen.make_schedule(args[0], rate=args[1], n_requests=args[2])
    with pytest.raises(ValueError):
        loadgen.make_schedule("poisson", long_frac=1.5)
    a = loadgen.make_schedule("poisson", rate=10.0, n_requests=50, seed=8)
    assert a.checksum() != GOLDEN["poisson"]


class TestReplay:
    """tests/test_observability_loadgen.py::TestReplay on the port."""

    def _schedule(self, n=40, rate=400.0, seed=13):
        return loadgen.make_schedule("poisson", rate=rate, n_requests=n,
                                     seed=seed)

    def test_replay_records_server_stamped_fields(self):
        s = self._schedule()

        def post(body):
            return {"usage": {"completion_tokens": body["max_tokens"]},
                    "kubeinfer": {"ttft_ms": 5.0, "tpot_ms": 1.0,
                                  "replica": "r0"}}

        res = loadgen.replay(s, post, vocab_size=100, speed=100.0)
        assert len(res.completed()) == len(res.records) == len(s.requests)
        assert res.errors() == 0
        assert res.ttft_ms_percentile(99.0) == pytest.approx(5.0)
        assert res.goodput_tokens_per_s() > 0.0
        for rec, req in zip(sorted(res.records, key=lambda r: r.index),
                            s.requests):
            assert rec.replica == "r0" and rec.tokens_out == req.max_new
            assert rec.trace_id

    def test_errors_are_data_points_not_run_failures(self):
        s = self._schedule(n=20)
        calls = {"n": 0}
        lock = threading.Lock()

        def post(body):
            with lock:
                calls["n"] += 1
                if calls["n"] % 2 == 0:
                    raise RuntimeError("HTTP 503")
            return {"usage": {"completion_tokens": 1},
                    "kubeinfer": {"ttft_ms": 1.0}}

        res = loadgen.replay(s, post, vocab_size=100, speed=100.0)
        assert len(res.completed()) == 10 and res.errors() == 10
        assert all(e.error == "RuntimeError: HTTP 503"
                   for e in res.records if not e.ok)

    def test_empty_percentile_is_nan_not_crash(self):
        def post(body):
            raise RuntimeError("down")

        res = loadgen.replay(self._schedule(n=5), post, vocab_size=100,
                             speed=100.0)
        assert math.isnan(res.ttft_ms_percentile(99.0))

    def test_replay_spans_carry_the_join_key(self):
        s = self._schedule(n=6)
        tracing.RECORDER.clear()

        def post(body):
            return {"usage": {"completion_tokens": 1},
                    "kubeinfer": {"ttft_ms": 1.0}}

        res = loadgen.replay(s, post, vocab_size=100, speed=100.0)
        roots = [sp for sp in tracing.RECORDER.snapshot()
                 if sp.name == "client.request"]
        assert {sp.trace_id for sp in roots} == \
            {r.trace_id for r in res.records}


# --- fleetview against the reference -------------------------------------------


def synth_request(rec, t0=100.0, replica="r0", migrate_to=None):
    """tests/test_observability_envelope.py's synthetic request: queue
    8 ms, route 1 ms, prefill 20 ms, decode 60 ms, and (migrating) a 5 ms
    stream + 15 ms resume prefill on the target."""
    tr = {c: Tracer(c, recorder=rec)
          for c in ("client", "router", "engine", "inference-server")}
    root = tr["client"].start_span("client.request", start=t0)
    ctx = root.context
    tr["router"].record_span("router.route", start=t0 + 0.001,
                             end=t0 + 0.002, parent=ctx, replica=replica)
    tr["engine"].record_span("engine.queue_wait", start=t0 + 0.002,
                             end=t0 + 0.010, parent=ctx, replica=replica)
    tr["engine"].record_span("engine.prefill", start=t0 + 0.010,
                             end=t0 + 0.030, parent=ctx, replica=replica)
    dec = replica
    if migrate_to is not None:
        tr["inference-server"].record_span(
            "server.kv_import", start=t0 + 0.030, end=t0 + 0.035,
            parent=ctx, kind="chain", replica=migrate_to)
        tr["engine"].record_span("engine.prefill", start=t0 + 0.035,
                                 end=t0 + 0.050, parent=ctx,
                                 replica=migrate_to)
        dec = migrate_to
    tr["engine"].record_span(
        "engine.decode", start=t0 + (0.050 if migrate_to else 0.030),
        end=t0 + 0.090, parent=ctx, replica=dec)
    tr["client"].finish(root, end=t0 + 0.095)
    return root.trace_id


def as_reference(spans):
    """The same spans as the reference's ``Span`` objects."""
    out = []
    for s in spans:
        j = jtr.Span(s.name, s.component, s.trace_id, s.span_id,
                     s.parent_id, s.start, dict(s.attrs))
        j.end = s.end
        j.events = list(s.events)
        out.append(j)
    return out


def span_set():
    """Four requests (one migrated, one with a 1 s queue on r1) and a
    trace with no engine span."""
    rec = SpanRecorder(name="test.TorchFleetview.rec")
    synth_request(rec, t0=200.0)
    synth_request(rec, t0=100.0, replica="p0", migrate_to="d1")
    synth_request(rec, t0=300.0, replica="r1")
    tr = Tracer("router", recorder=rec)
    root = tr.start_span("client.request", start=1.0)
    tr.record_span("router.route", start=1.0, end=1.1,
                   parent=root.context, replica="r0")
    tr.finish(root, end=1.2)
    eng = Tracer("engine", recorder=rec)
    ctx = tracing.new_root_context()
    eng.record_span("engine.queue_wait", start=5.0, end=6.0, parent=ctx,
                    replica="r1")
    eng.record_span("engine.prefill", start=6.0, end=6.2, parent=ctx,
                    replica="r1")
    return rec.snapshot()


def test_ledgers_and_tail_equal_the_references():
    spans = span_set()
    ours = fleetview.build_ledgers(spans)
    ref = jfv.build_ledgers(as_reference(spans))
    assert [led.to_dict() for led in ours] == [led.to_dict() for led in ref]
    assert len(ours) == 4
    for led in ours:
        assert abs(sum(led.phase_s.values()) + led.other_s - led.e2e_s) \
            < 1e-9
    migrated = next(led for led in ours if led.hops == 2)
    assert migrated.phase_replicas["prefill"] == ["p0", "d1"]
    for q in (50.0, 90.0, 99.0):
        assert fleetview.tail_attribution(ours, q) == \
            jfv.tail_attribution(ref, q)
    assert fleetview.tail_attribution([]) == jfv.tail_attribution([])


def points(pkg):
    mk = pkg.EnvelopePoint
    return [mk(offered_req_per_s=o, completed=c, errors=e,
               late_dispatches=0, goodput_tokens_per_s=o * 10,
               ttft_ms_p50=p / 2, ttft_ms_p99=p)
            for o, p, e, c in ((5, 40, 0, 100), (10, 80, 0, 100),
                               (20, 150, 0, 100), (40, 900, 0, 100),
                               (50, 45, 50, 100), (60, float("nan"), 0, 0))]


@pytest.mark.parametrize("slo", [30.0, 100.0, 200.0, 1000.0])
def test_knee_equals_the_references(slo):
    got = fleetview.detect_knee(points(fleetview), slo)
    want = jfv.detect_knee(points(jfv), slo)
    assert (got and got.to_dict()) == (want and want.to_dict())


def test_envelope_point_equals_the_references():
    s = loadgen.make_schedule("poisson", rate=400.0, n_requests=12, seed=5)

    def post(body):
        return {"usage": {"completion_tokens": body["max_tokens"]},
                "kubeinfer": {"ttft_ms": 2.0 + len(body["prompt"]) % 7}}

    res = loadgen.replay(s, post, vocab_size=50, speed=100.0)
    got = fleetview.envelope_point(s.offered_req_per_s(), res).to_dict()
    want = jfv.envelope_point(s.offered_req_per_s(), res).to_dict()
    assert got == want
    empty = SimpleNamespace(
        completed=lambda: [], errors=lambda: 0, late_dispatches=0,
        goodput_tokens_per_s=lambda: 0.0,
        ttft_ms_percentile=lambda q: float("nan"))
    assert math.isnan(fleetview.envelope_point(3.0, empty).ttft_ms_p99)


class _StubRing:
    def __init__(self, recs):
        self.recs = list(recs)

    def snapshot(self, since_seq=-1):
        return [r for r in self.recs if r.seq > since_seq]


def stub_engine(n_steps=3, n_flights=2):
    steps = [SimpleNamespace(seq=i, t=float(i), live_rows=i % 4)
             for i in range(n_steps)]
    flights = [SimpleNamespace(seq=i, t=float(i), queue_depth=i,
                               kv_in_use=4 + i, kv_free=4 - i)
               for i in range(n_flights)]
    return SimpleNamespace(profiler=_StubRing(steps),
                           flight=_StubRing(flights))


def test_fleetview_drain_and_merged_trace_equal_the_references():
    spans = span_set()
    views = (fleetview.FleetView(recorder=SpanRecorder(name="t.fv.a")),
             jfv.FleetView(recorder=jtr.SpanRecorder(name="t.fv.b")))
    engines = [(stub_engine(), stub_engine(5, 1)) for _ in views]
    drains = []
    for fv, (e0, e1) in zip(views, engines):
        fv.register("r0", e0)
        fv.register("r1", e1)
        got = [fv.drain(), fv.drain()]
        e0.profiler.recs.append(SimpleNamespace(seq=3, t=3.0, live_rows=1))
        got.append(fv.drain())
        drains.append(got)
    assert drains[0] == drains[1]
    assert drains[0][0] == {"r0": (3, 2), "r1": (5, 1)}
    assert drains[0][1] == {"r0": (0, 0), "r1": (0, 0)}  # exactly once
    assert len(views[0].steps("r0")) == 4
    ours = views[0].merged_chrome_trace(spans)
    ref = views[1].merged_chrome_trace(as_reference(spans))
    assert json.loads(json.dumps(ours)) == json.loads(json.dumps(ref))
    names = {e["args"]["name"] for e in ours["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"r0:engine", "r0:router", "client", "r0:counters"} <= names


def test_fleetview_drains_the_ports_profiler_and_flight_rings():
    from kubeinfer_tpu_torch.observability.flightrecorder import (
        FlightRecorder,
    )
    from kubeinfer_tpu_torch.observability.stepprof import StepProfiler

    prof = StepProfiler(n_slots=2, capacity=8)
    flight = FlightRecorder(capacity=8)
    fv = fleetview.FleetView()
    fv.register("r0", SimpleNamespace(profiler=prof, flight=flight))
    for i in range(3):
        prof.record("decode", bucket=4, live_rows=2, live_tokens=8,
                    padded_tokens=8, start=float(i), end=float(i) + 0.5)
    flight.note("admit", queue_depth=1, req=1, slot=0)
    assert fv.drain() == {"r0": (3, 1)}
    assert fv.drain() == {"r0": (0, 0)}


# --- one routed request on the port, one ledger ---------------------------------


def test_routed_request_is_one_contiguous_ledger():
    from kubeinfer_tpu_torch.inference import PRESETS, init_params
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.server import InferenceServer
    from kubeinfer_tpu_torch.router import FleetRouter, RouterServer

    cfg = PRESETS["tiny"]
    params = init_params(cfg, seed=0, device="cpu")
    cont = ContinuousEngine(params, cfg, n_slots=2, cache_len=128,
                            block_size=16, device="cpu").start()
    srv = InferenceServer(Engine(params, cfg, device="cpu"), model_id="r0",
                          port=0, continuous=cont, device="cpu").start()
    router = FleetRouter(device="cpu")
    router.add_replica("r0", f"http://127.0.0.1:{srv.port}")
    rs = RouterServer(router)
    fv = fleetview.FleetView()
    fv.register("r0", cont)
    try:
        rs.poll_once()
        tracing.RECORDER.clear()
        with Tracer("client").span("client.request") as sp:
            code, _ = rs.forward(json.dumps(
                {"prompt": [3] * 12, "max_tokens": 3}).encode())
        assert code == 200
        steps, flights = fv.drain()["r0"]
        assert steps > 0 and flights > 0 and fv.drain() == {"r0": (0, 0)}
    finally:
        rs.stop()
        srv.stop()
        cont.stop()
    spans = [s for s in tracing.RECORDER.snapshot()
             if s.trace_id == sp.trace_id]
    (led,) = fleetview.build_ledgers(spans)
    assert led.hops == 1
    for ph in ("route", "prefill", "decode"):
        assert led.phase_s[ph] > 0.0, ph
    assert led.phase_replicas["prefill"] == ["r0"]
    assert led.phase_replicas["decode"] == ["r0"]
    assert abs(sum(led.phase_s.values()) + led.other_s - led.e2e_s) < 1e-9
    by_name = {s.name: s for s in spans}
    assert by_name["engine.queue_wait"].end == \
        pytest.approx(by_name["engine.prefill"].start, abs=1e-6)
    assert by_name["engine.prefill"].end == \
        pytest.approx(by_name["engine.decode"].start, abs=1e-6)
    assert [led.to_dict() for led in jfv.build_ledgers(
        as_reference(spans))] == [led.to_dict()]


def test_cli_writes_a_trace_and_needs_a_card_unless_told(tmp_path):
    import subprocess
    import sys

    out = tmp_path / "trace.json"
    done = subprocess.run(
        [sys.executable, "-m", "kubeinfer_tpu_torch.observability",
         "--device", "cpu", "--out", str(out), "--max-tokens", "4"],
        capture_output=True, text=True, timeout=240)
    assert done.returncode == 0, done.stderr
    doc = json.loads(out.read_text())
    comps = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("name") == "process_name"}
    assert {"client", "inference-server", "engine", "store"} <= comps
    if not _has_card():
        for mod in ("kubeinfer_tpu_torch.observability",
                    "kubeinfer_tpu_torch.router"):
            extra = (["--out", str(tmp_path / "x.json")]
                     if mod.endswith("observability")
                     else ["--replica", "r0=http://127.0.0.1:9"])
            done = subprocess.run([sys.executable, "-m", mod, *extra],
                                  capture_output=True, text=True,
                                  timeout=120)
            assert done.returncode != 0
            assert "CUDA is not available" in done.stderr


def _has_card() -> bool:
    import torch

    return torch.cuda.is_available()
