"""The port's fleet router in front of port tiny servers, on the CPU
(``device="cpu"``), over loopback HTTP.

The reference's cases, on the port:

- ``tests/test_router.py::TestRouterHTTP`` (affinity sticks and is
  annotated, a string prompt's 400 relayed, ``/replicas`` and
  ``/metrics``, the poll) and ``TestRouterChaos`` (a decode replica and
  the prefill replica killed under traffic, an injected proxy fault:
  every answer carries the tokens of an uninterrupted run);
- ``tests/test_disagg.py::TestRouterTwoPhase``;
- ``tests/test_migration.py::TestRouterMigration`` and
  ``TestMigrationChaos``.

Expected tokens come from a fresh port engine on the same weights (the
port's streams equal the reference's: ``tests/test_torch_batching.py``).
No sleep stands in for synchronisation in the drain cases: the source
engine holds its scheduler at a window boundary once the session has
decoded two tokens (``gated``) until the drain flag is up, and every
wait has its own timeout.
"""

from __future__ import annotations

import json
import queue
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from kubeinfer_tpu_torch.inference import PRESETS, init_params
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.server import InferenceServer
from kubeinfer_tpu_torch.metrics.registry import breaker_transitions_total
from kubeinfer_tpu_torch.resilience.faultpoints import REGISTRY, FaultSpec
from kubeinfer_tpu_torch.router import FleetRouter, RouterServer

TINY = PRESETS["tiny"]
BS = 16
WAIT_S = 60


@pytest.fixture(autouse=True)
def _clean_faults():
    REGISTRY.disarm()
    REGISTRY.seed(42)
    yield
    REGISTRY.disarm()


@pytest.fixture(scope="module")
def params():
    return init_params(TINY, seed=0, device="cpu")


def gated(min_tokens):
    """A ContinuousEngine whose scheduler, at the first window boundary
    where a slot has decoded ``min_tokens`` tokens, sets ``ready`` and
    waits for ``go`` (or its own stop)."""

    class Gated(ContinuousEngine):
        def _maybe_preempt(self):
            super()._maybe_preempt()
            if self.go.is_set():
                return
            if any(r is not None and len(r.out_tokens) >= min_tokens
                   for r in self._slot_req):
                self.ready.set()
                for _ in range(int(WAIT_S / 0.01)):
                    if self.go.wait(0.01) or self._stop.is_set():
                        return

    return Gated


def mk_engine(params, gate=None, **kw):
    cls = gated(gate) if gate is not None else ContinuousEngine
    eng = cls(params, TINY, n_slots=2, cache_len=128, block_size=BS,
              device="cpu", **kw)
    eng.ready, eng.go = threading.Event(), threading.Event()
    return eng.start()


def mk_replica(params, name, gate=None, **kw):
    cont = mk_engine(params, gate, **kw)
    srv = InferenceServer(Engine(params, TINY, device="cpu"), model_id=name,
                          port=0, continuous=cont, device="cpu").start()
    return srv, cont


def mk_fleet(params, names=("r0", "r1"), gate=None, **kw):
    servers = {n: mk_replica(params, n, gate if n == "r0" else None, **kw)
               for n in names}
    router = FleetRouter(device="cpu")
    for n, (srv, _) in servers.items():
        router.add_replica(n, f"http://127.0.0.1:{srv.port}")
    rs = RouterServer(router, port=0).start(poll=False)
    rs.poll_once()
    return servers, router, rs


def stop_fleet(servers, rs):
    rs.stop()
    for srv, cont in servers.values():
        cont.go.set()
        try:
            srv.stop()
        except Exception:  # noqa: BLE001 — may already be chaos-killed
            pass
        cont.stop()


def post(port, body, timeout=WAIT_S):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/completions",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def forward(rs, body):
    code, payload = rs.forward(json.dumps(body).encode())
    return code, json.loads(payload)


def opened(edge):
    """Times ``edge``'s breaker went open. A request already in flight
    when its replica dies may still answer after the breaker opened, and
    its success closes the breaker again, so the end state alone cannot
    show that the kill tripped it."""
    return breaker_transitions_total.value(edge, "open")


def expected(params, prompts, n_new, **kw):
    ref = mk_engine(params)
    try:
        return {tuple(p): ref.generate(p, max_new_tokens=n_new, eos_id=-1,
                                       timeout=WAIT_S, **kw)
                for p in prompts}
    finally:
        ref.stop()


def prompt_tokens(n, seed=11):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def wait_for(cond, timeout=WAIT_S):
    ev = threading.Event()
    for _ in range(int(timeout / 0.002)):
        if cond():
            return True
        ev.wait(0.002)
    return False


FAMS = [list(range(1, 33)), list(range(100, 132))]


# --- tests/test_router.py::TestRouterHTTP ------------------------------------


class TestRouterHTTP:
    @pytest.fixture(scope="class")
    def fleet(self, params):
        servers, router, rs = mk_fleet(params)
        yield servers, router, rs
        stop_fleet(servers, rs)

    def test_affinity_sticks_and_annotates(self, fleet):
        _, router, rs = fleet
        for f in FAMS:
            _, first = post(rs.port, {"prompt": f + [50], "max_tokens": 2})
            _, second = post(rs.port, {"prompt": f + [51], "max_tokens": 2})
            assert second["kubeinfer"]["replica"] == \
                first["kubeinfer"]["replica"]
            assert second["kubeinfer"]["match_blocks"] >= 2
            assert second["kubeinfer"]["fallback"] is False
        assert "choices" in second and "ttft_ms" in second["kubeinfer"]
        assert router.affinity_hit_rate > 0

    def test_string_prompt_verdict_relayed(self, fleet):
        _, _, rs = fleet
        req = urllib.request.Request(
            f"http://127.0.0.1:{rs.port}/v1/completions",
            data=json.dumps({"prompt": "hello", "max_tokens": 2}).encode(),
            method="POST", headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=WAIT_S)
        assert ei.value.code == 400

    def test_debug_and_metrics_endpoints(self, fleet):
        _, _, rs = fleet
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rs.port}/replicas", timeout=10) as r:
            snap = json.loads(r.read())
        assert {v["name"] for v in snap} == {"r0", "r1"}
        assert all(v["breaker"] == "closed" and v["role"] == "decode"
                   for v in snap)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rs.port}/metrics", timeout=10) as r:
            body = r.read().decode()
        assert "kubeinfer_router_requests_total" in body
        assert "kubeinfer_router_affinity_hit_ratio" in body
        with urllib.request.urlopen(
                f"http://127.0.0.1:{rs.port}/health", timeout=10) as r:
            assert r.read() == b"OK"

    def test_poll_refreshes_authoritative_view(self, fleet):
        _, router, rs = fleet
        assert rs.poll_once() == 2
        views = {v.name: v for v in router.replicas()}
        assert views["r0"].block_size == BS and views["r0"].version >= 0


# --- tests/test_router.py::TestRouterChaos -------------------------------------


def run_clients(rs, prompts, workers, kill):
    """Serve ``prompts[:4]`` in order, then the rest from ``workers``
    threads while ``kill()`` runs; returns [(prompt, status, body)]."""
    results: queue.Queue = queue.Queue()
    work: queue.Queue = queue.Queue()

    def client():
        while True:
            try:
                p = work.get_nowait()
            except queue.Empty:
                return
            results.put((p, *post(rs.port, {"prompt": p, "max_tokens": 4})))

    for p in prompts[:4]:
        work.put(p)
    client()
    for p in prompts[4:]:
        work.put(p)
    threads = [threading.Thread(target=client) for _ in range(workers)]
    for t in threads:
        t.start()
    kill()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads)
    return [results.get() for _ in range(results.qsize())]


class TestRouterChaos:
    PROMPTS = [f + [200 + i] for i, f in enumerate(FAMS * 6)]

    def test_replica_kill_midrun_is_token_lossless(self, params):
        servers, router, rs = mk_fleet(params)
        try:
            expect = expected(params, self.PROMPTS, 4)
            victim = router.route(self.PROMPTS[0]).replica
            opened0 = opened(f"router.proxy[{victim}]")
            got = run_clients(rs, self.PROMPTS, 3,
                              lambda: servers[victim][0].stop())
            assert len(got) == len(self.PROMPTS)
            for p, status, body in got:
                assert status == 200
                assert body["choices"][0]["tokens"] == expect[tuple(p)]
            assert opened(f"router.proxy[{victim}]") > opened0
            sk = router.metrics["skipped"]
            assert sk.value(victim, "breaker") + sk.value(victim, "failed") > 0
            survivor = "r1" if victim == "r0" else "r0"
            assert router.metrics["requests"].value(survivor, "ok") > 0
        finally:
            stop_fleet(servers, rs)

    def test_prefill_replica_kill_midstream_is_token_lossless(self, params):
        servers, router, rs = mk_fleet(params)
        pre_srv, pre_cont = mk_replica(params, "p0")
        servers["p0"] = (pre_srv, pre_cont)
        router.add_prefill_replica("p0", f"http://127.0.0.1:{pre_srv.port}")
        rs.prefill_threshold = 32  # every long prompt takes two-phase
        rs.poll_once()
        try:
            expect = expected(params, self.PROMPTS, 4)
            opened0 = opened("router.prefill[p0]")
            got = run_clients(rs, self.PROMPTS[:4], 0, lambda: None)
            assert len(pre_srv.kv_exports) > 0  # two-phase engaged
            got += run_clients(rs, self.PROMPTS[4:], 3, pre_srv.stop)
            assert len(got) == len(self.PROMPTS)
            for p, status, body in got:
                assert status == 200
                assert body["choices"][0]["tokens"] == expect[tuple(p)]
            assert opened("router.prefill[p0]") > opened0
            fb = router.metrics["disagg_fallbacks"]
            assert fb.value("prefill_unreachable") + \
                fb.value("prefill_rejected") > 0
            assert sum(router.metrics["requests"].value(f"r{i}", "ok")
                       for i in range(2)) == len(self.PROMPTS)
        finally:
            stop_fleet(servers, rs)

    def test_injected_proxy_fault_rescores(self, params):
        servers, router, rs = mk_fleet(params)
        try:
            p = list(range(40, 72)) + [1]
            _, clean = post(rs.port, {"prompt": p, "max_tokens": 3})
            home = clean["kubeinfer"]["replica"]
            REGISTRY.arm(FaultSpec("router.proxy", "error", kind="reset",
                                   match=home))
            _, rerouted = post(rs.port, {"prompt": p, "max_tokens": 3})
            assert rerouted["kubeinfer"]["replica"] != home
            assert rerouted["choices"][0]["tokens"] == \
                clean["choices"][0]["tokens"]
            assert router.metrics["requests"].value(home, "unreachable") > 0
        finally:
            stop_fleet(servers, rs)


# --- tests/test_disagg.py::TestRouterTwoPhase ------------------------------------


def test_two_phase_route_is_token_identical(params):
    p, short = prompt_tokens(70, seed=31), prompt_tokens(20, seed=32)
    sampled = dict(temperature=0.7, seed=9)
    expect = expected(params, [p], 5)[tuple(p)]
    expect_s = expected(params, [p], 5, **sampled)[tuple(p)]
    expect_short = expected(params, [short], 3)[tuple(short)]
    servers, router, rs = mk_fleet(params, ("decode0", "decode1"))
    pre_srv, pre_cont = mk_replica(params, "prefill0")
    servers["prefill0"] = (pre_srv, pre_cont)
    router.add_prefill_replica("prefill0",
                               f"http://127.0.0.1:{pre_srv.port}")
    rs.prefill_threshold = 64
    rs.poll_once()
    try:
        code, doc = forward(rs, {"prompt": p, "max_tokens": 5})
        assert code == 200 and doc["choices"][0]["tokens"] == expect
        assert len(pre_srv.kv_exports) >= 1
        assert sum(servers[n][1].imports_total
                   for n in ("decode0", "decode1")) == 1
        assert router.metrics["prefill_routed"].value("prefill0") == 1
        code, doc = forward(rs, {"prompt": p, "max_tokens": 5, **sampled})
        assert code == 200 and doc["choices"][0]["tokens"] == expect_s
        before = router.metrics["prefill_routed"].value("prefill0")
        code, doc = forward(rs, {"prompt": short, "max_tokens": 3})
        assert code == 200 and doc["choices"][0]["tokens"] == expect_short
        assert router.metrics["prefill_routed"].value("prefill0") == before
        assert router.metrics["requests"].value("prefill0", "ok") == 0
        assert {v["name"]: v["role"] for v in rs.replica_snapshot()} == {
            "decode0": "decode", "decode1": "decode",
            "prefill0": "prefill"}
    finally:
        stop_fleet(servers, rs)


# --- tests/test_migration.py: TestRouterMigration, TestMigrationChaos -----------


def drain_mid_session(servers, rs, body, before_drain=lambda: None):
    """Forward ``body`` through the router on a thread; once the gated
    source (r0) decoded two tokens, drain it and release its scheduler.
    Returns (code, doc) of the routed request."""
    src_srv, src = servers["r0"]
    result = {}

    def client():
        result["code"], result["doc"] = forward(rs, body)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    assert src.ready.wait(WAIT_S), "the session never decoded on r0"
    before_drain()
    drainer = threading.Thread(target=lambda: src_srv.drain(timeout_s=30.0),
                               daemon=True)
    drainer.start()
    assert wait_for(lambda: src.draining)
    src.go.set()
    drainer.join(WAIT_S)
    t.join(WAIT_S)
    assert not drainer.is_alive() and not t.is_alive()
    return result["code"], result["doc"]


def test_drain_reroutes_and_finishes_token_identical(params):
    p, n_new = prompt_tokens(40, seed=71), 48
    expect = expected(params, [p], n_new)[tuple(p)]
    servers, router, rs = mk_fleet(params, gate=2, migration_chunk_blocks=1)
    try:
        code, doc = drain_mid_session(servers, rs,
                                      {"prompt": p, "max_tokens": n_new})
        assert code == 200
        assert doc["choices"][0]["tokens"] == expect
        assert doc["choices"][0]["finish_reason"] == "length"
        assert doc["kubeinfer"]["replica"] == "r1"
        assert doc["kubeinfer"]["resume_hops"] == 1
        assert router.metrics["migration_resumes"].value("r1") == 1
        assert len(servers["r0"][0].kv_exports) >= 1
        assert servers["r1"][1].imports_total >= 1
    finally:
        servers["r0"][1].undrain()
        stop_fleet(servers, rs)


def test_drain_verdict_marks_and_reroutes(params):
    p = prompt_tokens(24, seed=72)
    servers, router, rs = mk_fleet(params)
    try:
        servers["r0"][1].drain()
        # r1 looks heavily queued, r0 idle: only the 503 path saves this
        router.update_replica("r1", dict(servers["r1"][1].stats_summary(),
                                         queue_depth=50))
        code, doc = forward(rs, {"prompt": p, "max_tokens": 3})
        assert code == 200 and doc["kubeinfer"]["replica"] == "r1"
        assert router.metrics["requests"].value("r0", "draining") == 1
        code, doc = forward(rs, {"prompt": p, "max_tokens": 3})
        assert doc["kubeinfer"]["replica"] == "r1"
        assert router.metrics["skipped"].value("r0", "draining") >= 1
    finally:
        servers["r0"][1].undrain()
        stop_fleet(servers, rs)


def test_decode_replica_kill_mid_migration(params):
    """The resume target dies before the hand-off: the router relays the
    parked partial (finish_reason migrated, no_target counted), and a
    client-side resume on the undrained source finishes the stream."""
    p, n_new = prompt_tokens(40, seed=81), 48
    expect = expected(params, [p], n_new)[tuple(p)]
    servers, router, rs = mk_fleet(params, gate=2, migration_chunk_blocks=1)
    try:
        # abrupt: closing the listener refuses new connections at once
        code, doc = drain_mid_session(
            servers, rs, {"prompt": p, "max_tokens": n_new},
            before_drain=lambda: servers["r1"][0]._httpd.socket.close())
        assert code == 200
        assert doc["choices"][0]["finish_reason"] == "migrated"
        toks = doc["choices"][0]["tokens"]
        assert len(toks) >= 2 and toks == expect[:len(toks)]
        assert doc["kubeinfer"]["resume_hops"] == 1
        assert router.metrics["migration_fallbacks"].value("no_target") == 1
        servers["r0"][1].undrain()
        code, doc = forward(rs, {"prompt": p, "max_tokens": n_new,
                                 "kubeinfer_resume": {"tokens": toks}})
        assert code == 200 and doc["choices"][0]["tokens"] == expect
        assert doc["kubeinfer"]["replica"] == "r0"
        assert servers["r0"][1].imports_total == 0
    finally:
        servers["r0"][1].undrain()
        stop_fleet(servers, rs)
