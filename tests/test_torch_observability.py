"""The port's observability against the JAX package's, on the CPU at the
``tiny`` preset: ``observability/stepprof.py`` and ``flightrecorder.py``
on explicit timestamps, and one request sequence through a JAX
``InferenceServer`` and a port one (the reference's parameters carried
across, blocks of 16, chunked prefill): greedy and sampled requests, a
chunked prompt and its prefix hit, an over-slot request on the engine
route and an invalid one, each finished before the next, so both
schedules are deterministic. The two sides then give the same
``/metrics`` families, label sets and counter values, the same histogram
counts, flight events, step records, ``stats_summary()``, ``kubeinfer``
object keys and ``/cache/summary`` and ``/debug/slo`` shapes.

Parks, sheds and a drain depend on timing, so each side's scrape is held
to that side's own engine there. The bearer token, TLS and the new flags
are exercised on the port's server alone."""

from __future__ import annotations

import json
import shutil
import ssl
import subprocess
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import batching as jb
from kubeinfer_tpu.inference import engine as jengine
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import server as jserver
from kubeinfer_tpu.observability import flightrecorder as jfr
from kubeinfer_tpu.observability import stepprof as jsp
from kubeinfer_tpu_torch.inference import batching as tb
from kubeinfer_tpu_torch.inference import engine as tengine
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.observability import flightrecorder as tfr
from kubeinfer_tpu_torch.observability import stepprof as tsp
from kubeinfer_tpu_torch.observability import tracing as ttracing

JT, TT = JP["tiny"], TP["tiny"]
BS = 16
WAIT_S = 120  # a wedged scheduler fails its test instead of the run
# families whose values are times or derived from times: only their
# presence (gauges) or their sample counts (histograms) compare
TIMED_GAUGES = {"kubeinfer_engine_goodput_tokens_per_second",
                "kubeinfer_slo_burn_rate", "kubeinfer_slo_budget_remaining"}


@pytest.fixture(scope="module")
def params():
    p = j_init(JT, jax.random.PRNGKey(0))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


# --- the step profiler and the flight recorder -----------------------------


def profile(mod, kv):
    prof = mod.StepProfiler(n_slots=4, capacity=5, kv_sample_every=3,
                            kv_stats=kv)
    steps = [("prefill", 32, 1, 24, 8, 1), ("chunk", 16, 1, 16, 0, 1),
             ("decode", 4, 2, 7, 9, 4), ("decode", 4, 2, 8, 8, 4),
             ("verify", 2, 2, 5, 1, 2), ("spec", 2, 2, 0, 0, 1),
             ("decode", 1, 1, 1, 3, 1), ("prefill", 16, 2, 3, 13, 1)]
    recs = [prof.record(ph, bucket=b, live_rows=r, live_tokens=lt,
                        padded_tokens=pt, start=10.0 + i,
                        end=10.25 + i, steps=k).to_dict()
            for i, (ph, b, r, lt, pt, k) in enumerate(steps)]
    return {
        "recs": recs,
        "ring": [r.to_dict() for r in prof.snapshot()],
        "since": [r.seq for r in prof.snapshot(since_seq=5)],
        "summary": [prof.summary(window_s=w, now=18.0) for w in (3.0, 60.0)],
        "compiles": prof.compile_count,
        "counters": prof.counter_events(pid=7),
    }


def test_step_profiler_matches_reference():
    kv_j, kv_t = iter(range(100)), iter(range(100))
    ref = profile(jsp, lambda: (next(kv_j), 50))
    got = profile(tsp, lambda: (next(kv_t), 50))
    assert got == ref
    assert got["ring"][0]["seq"] == 3 and got["compiles"] == 7


def flights(mod):
    fr = mod.FlightRecorder(capacity=4)
    # one request's legal chain (the JAX package's protocol lint reads
    # these call sites), then an engine-level event
    evs = [fr.note("submit", queue_depth=1, kv_in_use=2, kv_free=6, t=1.0,
                   req=1, prompt_tokens=8, max_new=4),
           fr.note("backpressure", t=1.25, req=1, reason="queue_depth_limit"),
           fr.note("admit", queue_depth=0, kv_in_use=3, kv_free=5, t=1.5,
                   req=1, slot=0),
           fr.note("preempt", queue_depth=2, kv_in_use=4, kv_free=4, t=2.5,
                   req=1, slot=0),
           fr.note("resume", queue_depth=1, kv_in_use=4, kv_free=4, t=3.0,
                   req=1, slot=1),
           fr.note("drain_start", t=3.5)]
    with pytest.raises(ValueError, match="unknown flight-recorder kind"):
        # lint: allow[protocol-kind] the unknown-kind rejection is the behavior under test
        fr.note("bogus")
    return {
        "evs": [e.to_dict() for e in evs],
        "dict": fr.to_dict(),
        "since": fr.to_dict(since_seq=3),
        "len": len(fr),
        "render": fr.render(),
        "counters": fr.counter_events(pid=3),
    }


def test_flight_recorder_matches_reference():
    ref, got = flights(jfr), flights(tfr)
    assert got == ref
    assert got["dict"]["recorded"] == 6 and got["len"] == 4
    assert [e["seq"] for e in got["since"]["events"]] == [4, 5]
    assert tfr.KINDS == jfr.KINDS
    assert tfr.get_monitor() is None


# --- one request sequence through both servers ------------------------------


def build(pkg, params, **kw):
    """A server over a started continuous engine (2 slots of 64, blocks of
    16, chunks of one block) and a per-request engine."""
    kw = dict(n_slots=2, cache_len=64, block_size=BS, prefill_chunk_blocks=1,
              **kw)
    if pkg == "jax":
        cont = jb.ContinuousEngine(params[0], JT, **kw).start()
        srv = jserver.InferenceServer(
            jengine.Engine(params[0], JT, max_cache_len=128), "tiny", port=0,
            continuous=cont).start()
    else:
        cont = tb.ContinuousEngine(params[1], TT, device="cpu", **kw).start()
        srv = ts.InferenceServer(
            tengine.Engine(params[1], TT, max_cache_len=128, device="cpu"),
            "tiny", port=0, continuous=cont, device="cpu").start()
    return srv, cont


def call(srv, path, body=None, token=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=None if body is None else json.dumps(body).encode())
    if token is not None:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


SEQUENCE = [
    dict(prompt=prompt(8, 1), max_tokens=5),
    dict(prompt=prompt(9, 2), max_tokens=5, temperature=0.8, top_k=5,
         seed=3),
    # two chunks, then the finalize
    dict(prompt=prompt(40, 3), max_tokens=5),
    # its two full blocks from the radix cache
    dict(prompt=prompt(40, 3), max_tokens=5),
    # 60 + 5 > the 64-wide slots: the per-request engine
    dict(prompt=prompt(60, 4), max_tokens=5),
    dict(prompt=[1, 2], top_p=0.0),
]


def scrape(text: str) -> dict:
    """Prometheus text -> {family: (type, {labels: value})}, a histogram's
    samples folded to its count per label set."""
    fams: dict = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            fams[name] = (kind, {})
        elif line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            name, _, labels = series.partition("{")
            for fam, (kind, samples) in fams.items():
                if kind == "histogram" and name == fam + "_count":
                    samples[labels] = float(value)
                elif name == fam and kind != "histogram":
                    samples[labels] = float(value)
    return fams


@pytest.fixture(scope="module")
def sequence(params):
    out = {}
    for pkg in ("jax", "port"):
        srv, cont = build(pkg, params)
        try:
            docs = [call(srv, "/v1/completions", body) for body in SEQUENCE]
            out[pkg] = {
                "docs": docs,
                "metrics": scrape(call(srv, "/metrics")[1]),
                "flight": cont.flight.snapshot(),
                "steps": cont.profiler.snapshot(),
                "summary": cont.stats_summary(),
                "cache": json.loads(call(srv, "/cache/summary")[1]),
                "slo": json.loads(call(srv, "/debug/slo")[1]),
                "bad_since": call(srv, "/debug/flightrecorder?since=x")[0],
                "sched": cont.scheduler_stats(),
            }
        finally:
            srv.stop()
            cont.stop()
    return out


def test_same_routes_and_kubeinfer_keys(sequence):
    routes = {}
    for pkg, side in sequence.items():
        codes = [code for code, _ in side["docs"]]
        assert codes == [200] * 5 + [400], pkg
        docs = [json.loads(body) for _, body in side["docs"][:5]]
        routes[pkg] = [d["kubeinfer"]["route"] for d in docs]
        for d in docs:
            assert sorted(d["kubeinfer"]) == ["route", "tpot_ms", "ttft_ms"]
            assert d["kubeinfer"]["ttft_ms"] >= 0 and \
                d["kubeinfer"]["tpot_ms"] >= 0
        assert side["bad_since"] == 400
    assert routes["port"] == routes["jax"] == ["continuous"] * 4 + ["engine"]
    for (_, jd), (_, td) in zip(sequence["jax"]["docs"][:5],
                                sequence["port"]["docs"][:5]):
        jd, td = json.loads(jd), json.loads(td)
        assert td["choices"][0]["tokens"] == jd["choices"][0]["tokens"]
        assert td["usage"] == jd["usage"]


def test_same_metrics(sequence):
    ref, got = sequence["jax"]["metrics"], sequence["port"]["metrics"]
    assert sorted(got) == sorted(ref)
    for fam, (kind, samples) in ref.items():
        assert got[fam][0] == kind, fam
        assert sorted(got[fam][1]) == sorted(samples), fam
        if fam not in TIMED_GAUGES:
            assert got[fam][1] == samples, fam
    m = got
    assert m["kubeinfer_inference_requests_total"][1] == {
        'route="continuous",outcome="ok"}': 4.0,
        'route="engine",outcome="ok"}': 1.0,
        'route="invalid",outcome="invalid"}': 1.0}
    assert m["kubeinfer_prefix_cache_hits_total"][1][""] == 1.0
    assert m["kubeinfer_prefill_chunks_total"][1][""] == 2.0
    assert m["kubeinfer_inference_completion_tokens_total"][1][""] == 25.0


def test_same_flight_events(sequence):
    def events(side):
        return [(e.kind, {k: v for k, v in e.detail.items() if k != "req"},
                 e.queue_depth, e.kv_in_use, e.kv_free)
                for e in side["flight"]]

    ref, got = events(sequence["jax"]), events(sequence["port"])
    assert got == ref
    assert [k for k, *_ in got].count("chunk") == 2
    assert {k for k, *_ in got} == {"submit", "admit", "chunk", "retire"}


def test_same_step_records(sequence):
    def steps(side):
        return [(r.phase, r.bucket, r.live_rows, r.n_slots, r.live_tokens,
                 r.padded_tokens, r.steps, r.compiled, r.kv_in_use,
                 r.kv_free) for r in side["steps"]]

    ref, got = steps(sequence["jax"]), steps(sequence["port"])
    assert got == ref
    assert {s[0] for s in got} == {"prefill", "chunk", "decode"}
    # the step histogram folded every record once
    hist = sequence["port"]["metrics"][
        "kubeinfer_engine_step_duration_seconds"][1]
    assert sum(hist.values()) == len(got)


def test_same_stats_summary_and_shapes(sequence):
    ref, got = sequence["jax"], sequence["port"]
    assert sorted(got["summary"]) == sorted(ref["summary"])
    timed = {"goodput_tokens_per_sec", "slo_burn", "kv_pool_bytes",
             "model_param_bytes"}
    for key, value in ref["summary"].items():
        if key not in timed:
            assert got["summary"][key] == value, key
    assert got["summary"]["prefix_hit_rate"] == 0.25
    assert sorted(got["cache"]) == sorted(ref["cache"]) == ["model",
                                                             "serving"]
    assert sorted(got["cache"]["serving"]) == sorted(ref["cache"]["serving"])

    def shape(doc):
        if isinstance(doc, dict):
            return {k: shape(v) for k, v in doc.items()}
        return type(doc).__name__

    assert shape(got["slo"]) == shape(ref["slo"])
    # the port's scheduler_stats also carries spec_served/spec_accepted
    assert {k: got["sched"][k] for k in ref["sched"]} == ref["sched"]


# --- parks, sheds and a drain: each side against its own engine -------------


def aggressive(pkg):
    return pkg.PreemptionPolicy(threshold_s=0.0005, objective=0.5,
                                burn_limit=0.5, cooldown_steps=1,
                                min_progress=1)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_parks_sheds_and_drain_scrape_their_own_engine(params, pkg):
    """A backlog against 2 slots under the reference tests' aggressive
    policy, sheds past ``queue_depth_limit``, then a drain: every counter
    of the scrape equals the engine's own (whatever the timing made)."""
    mod = jb if pkg == "jax" else tb
    srv, cont = build(pkg, params, preemption=aggressive(mod),
                      queue_depth_limit=3)
    results = [None] * 8

    def client(i):
        results[i] = call(srv, "/v1/completions",
                          dict(prompt=prompt(6 + i, 10 + i), max_tokens=10))

    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(WAIT_S)
            assert not th.is_alive()
        code, report = call(srv, "/admin/drain", {})
        assert code == 200 and json.loads(report)["drained"]
        m = scrape(call(srv, "/metrics")[1])
        sched = cont.scheduler_stats()
        kinds = [e.kind for e in cont.flight.snapshot()]
        steps = len(cont.profiler.snapshot())
    finally:
        srv.stop()
        cont.stop()
    codes = [code for code, _ in results]
    shed = codes.count(503)
    assert shed + codes.count(200) == 8

    def val(fam, labels=""):
        return m[fam][1].get(labels, 0.0)

    assert val("kubeinfer_preemptions_total") == sched["preempted"] == \
        kinds.count("preempt")
    assert val("kubeinfer_preemption_resumes_total") == sched["resumed"] == \
        kinds.count("resume")
    assert sched["resumed"] == sched["preempted"]
    assert val("kubeinfer_requests_shed_total",
               'reason="queue_depth_limit"}') == shed
    assert val("kubeinfer_inference_requests_total",
               'route="continuous",outcome="shed"}') == shed
    assert val("kubeinfer_inference_requests_total",
               'route="continuous",outcome="ok"}') == 8 - shed
    assert kinds.count("fail") == shed
    assert val("kubeinfer_engine_draining_state") == 1.0
    assert val("kubeinfer_migrations_total") == sched["migrated"] == 0
    assert kinds[-1] == "drain_start"
    assert val("kubeinfer_parked_requests") == sched["parked"] == 0
    assert sum(m["kubeinfer_engine_step_duration_seconds"][1].values()) == \
        steps


# --- the token, TLS and the flags (the port's server) -----------------------


@pytest.fixture(scope="module")
def armed(params):
    cont = tb.ContinuousEngine(params[1], TT, n_slots=2, cache_len=64,
                               block_size=BS, device="cpu").start()
    srv = ts.InferenceServer(
        tengine.Engine(params[1], TT, device="cpu"), "armed", port=0,
        continuous=cont, device="cpu", token="s3cret").start()
    yield srv, cont
    srv.stop()
    cont.stop()


@pytest.mark.parametrize("path", ["/debug/spans", "/debug/flightrecorder",
                                  "/debug/slo"])
@pytest.mark.parametrize("token", [None, "wrong"])
def test_debug_needs_the_token(armed, path, token):
    srv, _ = armed
    code, body = call(srv, path, token=token)
    assert code == 401 and json.loads(body) == {"error": "unauthorized"}
    assert call(srv, path, token="s3cret")[0] == 200


@pytest.mark.parametrize("token", [None, "wrong"])
def test_admin_drain_needs_the_token(armed, token):
    srv, cont = armed
    assert call(srv, "/admin/drain", {}, token=token)[0] == 401
    assert not cont.draining
    code, body = call(srv, "/admin/drain", {"resume": True}, token="s3cret")
    assert code == 200 and json.loads(body)["drained"]
    assert not cont.draining


def test_open_routes_stay_open(armed):
    srv, _ = armed
    assert call(srv, "/health") == (200, "OK")
    assert call(srv, "/metrics")[0] == 200
    assert call(srv, "/cache/summary")[0] == 200
    code, body = call(srv, "/v1/completions", dict(prompt=[1, 2, 3],
                                                   max_tokens=2))
    assert code == 200 and len(json.loads(body)["choices"][0]["tokens"]) == 2


def test_completion_over_tls(tmp_path):
    if shutil.which("openssl") is None:
        pytest.skip("no openssl CLI to make a certificate")
    cert, key = tmp_path / "cert.pem", tmp_path / "key.pem"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=127.0.0.1", "-addext", "subjectAltName=IP:127.0.0.1"],
        check=True, capture_output=True)
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0", "--batch-slots",
         "2", "--max-model-len", "128", "--tls-cert-file", str(cert),
         "--tls-key-file", str(key)], device="cpu")
    cont.start()
    srv.start()
    ctx = ssl.create_default_context(cafile=str(cert))
    body = json.dumps({"prompt": [3, 1, 4], "max_tokens": 3}).encode()
    try:
        with urllib.request.urlopen(
                f"https://127.0.0.1:{srv.port}/v1/completions", data=body,
                timeout=WAIT_S, context=ctx) as r:
            doc = json.loads(r.read())
        assert doc["kubeinfer"]["route"] == "continuous"
        assert len(doc["choices"][0]["tokens"]) == 3
        # plain HTTP to the TLS listener gets no answer
        with pytest.raises((urllib.error.URLError, ConnectionError, OSError)):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/health",
                                   timeout=10)
    finally:
        srv.stop()
        cont.stop()


def test_observability_flags_build_the_server(tmp_path):
    tok = tmp_path / "token"
    tok.write_text("tok-1\n")
    prev = ttracing.span_sampling()
    try:
        srv, cont = ts.build_server(
            ["--model", "tiny", "--random-init", "--port", "0",
             "--batch-slots", "2", "--max-model-len", "128",
             "--slo", "ttft:0.5:0.99", "--slo", "tpot:0.1:0.9",
             "--span-sample-every", "4", "--flight-capacity", "7",
             "--debug-token-file", str(tok)], device="cpu")
        try:
            assert ttracing.span_sampling() == 4
            objs = srv.slo.snapshot()["objectives"]
            assert sorted(objs) == ["tpot", "ttft"]
            assert objs["ttft"]["threshold_s"] == 0.5
            assert cont.flight.to_dict()["capacity"] == 7
            assert srv._token == "tok-1"
            assert cont.replica_name == "tiny"
        finally:
            srv.stop()
    finally:
        ttracing.set_span_sampling(prev)
    with pytest.raises(ValueError, match="flight_capacity"):
        ts.build_server(["--model", "tiny", "--random-init", "--port", "0",
                         "--flight-capacity", "0"], device="cpu")
