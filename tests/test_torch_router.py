"""The port's fleet router (``kubeinfer_tpu_torch/router``) against the
JAX package's, on the CPU, with no servers.

- Decisions: the reference tests' planted fleets (every gate of
  ``tests/test_router_solver.py::TestRouteBatchEquivalence``, the
  headroom plane of ``TestHeadroomGamma``, the identical caches of
  ``TestSpreadModes``) and ``bench.py:fleet_storm_bench``'s plant cut to
  20 replicas and 512 requests are built in both packages on a
  ``SimulatedClock``. ``route()``, ``route_batch`` in both engines and all
  three modes, and the routers' counters agree; a ``RouteDecision`` is
  compared field by field as a dict. The reference solves with
  ``accel="jnp"``, as its own tests do; the port on ``device="cpu"``
  (the plain ``route_pick``).
- The reference's cases of ``tests/test_router.py`` (``TestScoring``,
  ``TestFleetRouter``, ``TestStoreRoundTrip`` through the port's
  ``NodeAgent``), ``tests/test_router_solver.py`` (the batch gates,
  ``TestStormBatcher``, ``TestTokenizerPath``) and
  ``tests/test_migration.py::TestRouterDraining``, on the port's router.
- No fallback: ``FleetRouter()`` raises without a card, ``engine="auto"``
  is the solver, and a failing solve raises instead of taking the Python
  scorer.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from kubeinfer_tpu.inference import kv_blocks as jkv
from kubeinfer_tpu.router import FleetRouter as JRouter
from kubeinfer_tpu.utils.clock import SimulatedClock as JClock
from kubeinfer_tpu_torch.agent import NodeAgent
from kubeinfer_tpu_torch.api.workload import NodeState
from kubeinfer_tpu_torch.controlplane import Store
from kubeinfer_tpu_torch.inference.kv_blocks import (
    SUMMARY_FINGERPRINT_BUDGET,
    BlockPool,
    RadixCache,
    prefix_fingerprints,
)
from kubeinfer_tpu_torch.resilience.faultpoints import REGISTRY, FaultSpec
from kubeinfer_tpu_torch.router import (
    FleetRouter,
    NoReplicaError,
    RouterServer,
    scoring,
)
from kubeinfer_tpu_torch.router import core as tcore
from kubeinfer_tpu_torch.router.server import _StormBatcher
from kubeinfer_tpu_torch.solver import routing
from kubeinfer_tpu_torch.utils.clock import SimulatedClock

MODES = ("parity", "greedy", "auction")
PKGS = {
    "jax": SimpleNamespace(
        router=lambda clk, gamma: JRouter(clock=clk.now, gamma=gamma),
        clock=JClock, fps=jkv.prefix_fingerprints, solve={"accel": "jnp"}),
    "port": SimpleNamespace(
        router=lambda clk, gamma: FleetRouter(clock=clk.now, gamma=gamma,
                                              device="cpu"),
        clock=SimulatedClock, fps=prefix_fingerprints, solve={}),
}


@pytest.fixture(autouse=True)
def _clean_faults():
    REGISTRY.disarm()
    REGISTRY.seed(42)
    yield
    REGISTRY.disarm()


def summary_of(*paths, block_size=4, fps=prefix_fingerprints) -> dict:
    return {
        "fingerprints": sorted({fp for p in paths
                                for fp in fps(p, block_size)}),
        "version": 1, "block_size": block_size,
    }


def serving(queue_depth=0, n_slots=2, summary=None, **extra) -> dict:
    d = {"queue_depth": queue_depth, "n_slots": n_slots, **extra}
    if summary is not None:
        d["cache_summary"] = summary
    return d


def mk_router(clock=None):
    clk = clock or SimulatedClock(start=100.0)
    return FleetRouter(clock=clk.now, device="cpu"), clk


# --- planted fleets, built the same way in both packages --------------------


def plant_gates(pkg):
    """TestRouteBatchEquivalence.plant_fleet: warm, a tied pair, busy,
    stale, dead, draining and breaker-open replicas."""
    clk = pkg.clock(start=100.0)
    r = pkg.router(clk, 0.0)
    toks = list(range(16))
    summ = lambda p: summary_of(p, fps=pkg.fps)  # noqa: E731
    r.add_replica("dead", "http://dead")
    r.update_replica("dead", serving(summary=summ(toks)))
    clk.advance(scoring.DEAD_AFTER_S + 1)
    r.add_replica("stale", "http://stale")
    r.update_replica("stale", serving(summary=summ(toks)))
    clk.advance(scoring.STALE_AFTER_S + 1)
    for name, qd, s in [("warm", 0, summ(toks)), ("tie-b", 1, summ(toks[:8])),
                        ("tie-a", 1, summ(toks[:8])), ("busy", 6, summ(toks)),
                        ("drain", 0, summ(toks)), ("broken", 0, summ(toks))]:
        r.add_replica(name, f"http://{name}")
        r.update_replica(name, serving(queue_depth=qd, summary=s))
    r.mark_draining("drain")
    broken = next(v for v in r.replicas() if v.name == "broken")
    for _ in range(3):
        broken.breaker.record_failure()
    batch = [toks, toks[:8], [7] * 16, toks[:4], toks + [3, 3, 3, 3]]
    excludes = [frozenset(), frozenset(), frozenset(),
                frozenset({"warm", "busy"}), frozenset({"warm"})]
    return r, batch, excludes


def plant_headroom(pkg, gamma):
    """TestHeadroomGamma.plant: identical caches, KV fullness differs."""
    clk = pkg.clock(start=100.0)
    r = pkg.router(clk, gamma)
    toks = list(range(16))
    for name, free, used in [("full", 10, 90), ("roomy", 90, 10)]:
        r.add_replica(name, f"http://{name}")
        r.update_replica(name, serving(
            summary=summary_of(toks, fps=pkg.fps),
            kv_blocks_free=free, kv_blocks_in_use=used))
    return r, [toks, toks[:8], [7] * 16, toks[:4]], None


def plant_spread(pkg, n=3):
    """TestSpreadModes.plant_identical: n replicas with the same cache."""
    clk = pkg.clock(start=100.0)
    r = pkg.router(clk, 0.0)
    toks = list(range(16))
    for i in range(n):
        r.add_replica(f"r{i}", f"http://r{i}")
        r.update_replica(f"r{i}", serving(
            summary=summary_of(toks, fps=pkg.fps)))
    return r, [toks] * 12, None


def plant_storm(pkg):
    """bench.py:fleet_storm_bench's plant (``chip_smoke.fleet_plant``, as
    phase (34a) builds it on the card) cut to 20 replicas and 512
    requests."""
    r = pkg.router(pkg.clock(start=1000.0), 0.0)
    requests, *_ = chip_smoke.fleet_plant(r, n_requests=512, n_replicas=20,
                                          fps=pkg.fps)
    return r, requests, None


PLANTS = {
    "gates": plant_gates,
    "headroom-0": lambda pkg: plant_headroom(pkg, 0.0),
    "headroom-2.5": lambda pkg: plant_headroom(pkg, 2.5),
    "headroom-8": lambda pkg: plant_headroom(pkg, 8.0),
    "spread": plant_spread,
    "storm-20x512": plant_storm,
}


def as_dicts(decisions):
    return [None if d is None else dataclasses.asdict(d) for d in decisions]


def counters(router) -> list[str]:
    """The router's scrape without the solve-time histogram (wall time)."""
    return [ln for ln in router.registry.render().splitlines()
            if "kubeinfer_router_solve_seconds" not in ln]


def decisions_of(pkg, plant):
    r, batch, excludes = plant(pkg)
    out = {"route": as_dicts([
        r.route(t, exclude=(excludes[i] if excludes else frozenset()))
        for i, t in enumerate(batch)])}
    for engine, modes in (("python", ("parity",)), ("solver", MODES)):
        for mode in modes:
            kw = pkg.solve if engine == "solver" else {}
            out[engine, mode] = as_dicts(r.route_batch(
                batch, excludes, engine=engine, mode=mode, **kw))
    out["affinity_hit_rate"] = r.affinity_hit_rate
    out["counters"] = counters(r)
    return out


@pytest.mark.parametrize("plant", sorted(PLANTS))
def test_decisions_equal_the_references(plant):
    got = decisions_of(PKGS["port"], PLANTS[plant])
    want = decisions_of(PKGS["jax"], PLANTS[plant])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], (plant, key)
    # parity and the python engine agree with route(), as in the
    # reference's own tests
    assert got["solver", "parity"] == got["python", "parity"] == got["route"]


# --- the reference's batch gates on the port --------------------------------


def test_tie_breaks_by_name_both_engines():
    r, batch, _ = plant_gates(PKGS["port"])
    toks = batch[0]
    ex = frozenset({"warm", "busy"})
    assert r.route(toks, exclude=ex).replica == "tie-a"
    for engine in ("python", "solver"):
        got = r.route_batch([toks, toks], [ex, ex], engine=engine)
        assert [d.replica for d in got] == ["tie-a", "tie-a"], engine


def test_dead_dropout_and_masks_in_batch():
    r, batch, _ = plant_gates(PKGS["port"])
    picks = {d.replica for d in r.route_batch([batch[0]] * 6)}
    assert picks == {"warm"}
    assert r.metrics["skipped"].value("dead", "dead") == 6
    assert r.metrics["skipped"].value("drain", "draining") == 6
    assert r.metrics["skipped"].value("broken", "breaker") == 6
    # engine="auto" is the solver, counted under its mode
    assert r.metrics["solver_routed"].value("parity") == 6
    assert r.metrics["solver_routed"].value("python") == 0


def test_b1_degenerate_case_byte_compatible():
    r, batch, _ = plant_gates(PKGS["port"])
    for t in (batch[0], [9] * 16, batch[0][:8]):
        want = r.route(t)
        for engine in ("python", "solver"):
            assert r.route_batch([t], engine=engine) == [want], engine


def test_empty_batch_excludes_and_bad_arguments():
    r, _ = mk_router()
    assert r.route_batch([]) == []
    assert r.route_batch([[1, 2, 3, 4]]) == [None]
    r, batch, _ = plant_gates(PKGS["port"])
    got = r.route_batch([batch[0]] * 2, [frozenset(), frozenset({"warm"})])
    assert got[0].replica == "warm" and got[1].replica != "warm"
    with pytest.raises(ValueError):
        r.route_batch([batch[0]], engine="carrier-pigeon")
    with pytest.raises(ValueError):
        r.route_batch([batch[0]], engine="solver", mode="chaotic")


def test_spread_modes():
    r, batch, _ = plant_spread(PKGS["port"])
    assert {d.replica for d in r.route_batch(batch, mode="parity")} == {"r0"}
    greedy = [d.replica for d in r.route_batch(batch, mode="greedy")]
    counts = [greedy.count(f"r{i}") for i in range(3)]
    assert set(greedy) == {"r0", "r1", "r2"} and max(counts) - min(counts) <= 1
    r, batch, _ = plant_spread(PKGS["port"], n=2)
    got = r.route_batch(batch[:9], mode="auction")
    assert all(d is not None for d in got)
    assert {d.replica for d in got} == {"r0", "r1"}


def test_gamma_steers_to_free_kv():
    r, batch, _ = plant_headroom(PKGS["port"], 8.0)
    got = r.route(batch[0])
    assert got.replica == "roomy"
    depth = scoring.match_depth(prefix_fingerprints(batch[0], 4),
                                frozenset(summary_of(batch[0])["fingerprints"]))
    assert got.score == pytest.approx(scoring.replica_score(
        depth, 0.0, False, gamma=8.0, headroom=0.9))


# --- no fallback -------------------------------------------------------------


def test_router_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        FleetRouter()
    assert FleetRouter(device="cpu").device == torch.device("cpu")


def test_a_failing_solve_raises_and_never_takes_the_python_scorer(
        monkeypatch):
    r, batch, _ = plant_gates(PKGS["port"])

    def broken(*a, **kw):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(routing, "solve_routes", broken)
    for engine in ("auto", "solver"):
        with pytest.raises(RuntimeError, match="solve failed"):
            r.route_batch(batch, engine=engine)
    assert r.metrics["solver_routed"].value("python") == 0
    assert not hasattr(tcore, "_solver_importable")


def storm_server(monkeypatch, solve):
    """A RouterServer with a 50 ms storm window over two warm replicas,
    its proxy stubbed, ``routing.solve_routes`` replaced by ``solve``
    and ``FleetRouter.route`` (the per-request scorer) made to fail the
    test if it is ever reached."""
    r, _ = mk_router()
    for name, toks in (("a", list(range(16))), ("b", list(range(50, 66)))):
        r.add_replica(name, f"http://{name}")
        r.update_replica(name, serving(summary=summary_of(toks)))
    srv = RouterServer(r, poll_interval_s=0, storm_window_s=0.05)
    srv._proxy = lambda decision, raw: b'{"choices": []}'
    monkeypatch.setattr(routing, "solve_routes", solve)

    def scorer(*a, **kw):
        raise AssertionError("the per-request scorer was reached")

    monkeypatch.setattr(r, "route", scorer)
    return srv, r


def forward_all(srv, n=6, out=None):
    """n concurrent first placements through ``srv.forward``; each
    (status, body) lands in ``out`` as it is answered."""
    out = {} if out is None else out

    def go(i):
        code, payload = srv.forward(json.dumps(
            {"prompt": list(range(16)) + [i], "max_tokens": 4}).encode())
        out[i] = (code, json.loads(payload))

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert len(out) == n
    return out


def test_a_failing_storm_solve_fails_every_request_of_its_batch(
        monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("solve failed")

    srv, r = storm_server(monkeypatch, broken)
    try:
        out = forward_all(srv)
    finally:
        srv.stop()
    assert {code for code, _ in out.values()} == {503}
    assert {doc["error"]["type"] for _, doc in out.values()} == \
        {"route_solve_failed"}
    assert all("solve failed" in doc["error"]["message"]
               for _, doc in out.values())
    assert all(r.metrics["solver_routed"].value(m) == 0
               for m in (*MODES, "python"))
    assert sum(r.metrics["requests"].value(n, "ok") for n in "ab") == 0


def test_a_late_storm_solve_fails_its_followers_not_to_the_scorer(
        monkeypatch):
    release = threading.Event()
    solve = routing.solve_routes

    def held(*a, **kw):
        release.wait(timeout=30.0)
        return solve(*a, **kw)

    srv, r = storm_server(monkeypatch, held)
    srv._storm.follower_timeout_s = 0.3
    out: dict[int, tuple[int, dict]] = {}
    th = threading.Thread(target=forward_all, args=(srv, 6, out))
    try:
        th.start()
        # the five followers answer while the leader's solve is held
        deadline = time.monotonic() + 20.0
        while len(out) < 5 and time.monotonic() < deadline:
            time.sleep(0.02)
        followers = dict(out)
        release.set()
        th.join(timeout=30.0)
    finally:
        release.set()
        srv.stop()
    assert sorted(code for code, _ in followers.values()) == [503] * 5
    assert {doc["error"]["type"] for _, doc in followers.values()} == \
        {"route_solve_failed"}
    assert sorted(code for code, _ in out.values()) == [200] + [503] * 5
    assert r.metrics["solver_routed"].value("python") == 0


# --- tests/test_router.py on the port ---------------------------------------


def radix_summary(*paths, block_size=4) -> dict:
    """A real RadixCache summary holding the given token paths."""
    pool = BlockPool(num_blocks=64, block_size=block_size)
    cache = RadixCache(pool)
    for p in paths:
        blocks = pool.alloc(len(p) // block_size)
        cache.insert(p, blocks)
        pool.unref(blocks)
    return cache.summary()


class TestScoring:
    def test_queue_pressure_match_depth_and_stale_penalty(self):
        assert scoring.queue_pressure({"queue_depth": 4, "n_slots": 2}) == 2.0
        assert scoring.queue_pressure({"queue_depth": 3}) == 3.0
        assert scoring.queue_pressure(None) == 0.0
        assert scoring.queue_pressure({"queue_depth": "wat"}) == 0.0
        fps = prefix_fingerprints(list(range(12)), 4)
        assert scoring.match_depth(fps, set(fps)) == 3
        assert scoring.match_depth(fps, {fps[2]}) == 3
        assert scoring.match_depth(fps, set()) == 0
        fresh = scoring.replica_score(4, 0.5, stale=False)
        assert scoring.replica_score(4, 0.5, stale=True) == \
            fresh - scoring.STALE_PENALTY_BLOCKS

    def test_constants_pinned_to_scoring(self):
        import inspect

        sig = inspect.signature(routing.solve_routes)
        assert sig.parameters["alpha"].default == scoring.ALPHA_QUEUE_BLOCKS
        assert sig.parameters["stale_penalty"].default == \
            scoring.STALE_PENALTY_BLOCKS


class TestFleetRouter:
    def test_affinity_beats_idle_no_match(self):
        r, _ = mk_router()
        toks = list(range(12))
        r.add_replica("warm", "http://w")
        r.add_replica("cold", "http://c")
        r.update_replica("warm", serving(summary=radix_summary(toks)))
        r.update_replica("cold", serving(summary=radix_summary([9, 9, 9, 9])))
        d = r.route(toks + [77])
        assert (d.replica, d.match_blocks, d.fallback) == ("warm", 3, False)
        assert d.match_tokens == 12

    def test_queue_pressure_overrides_shallow_match(self):
        r, _ = mk_router()
        toks = [5, 6, 7, 8]
        r.add_replica("busy", "http://b")
        r.add_replica("idle", "http://i")
        r.update_replica("busy", serving(queue_depth=4, n_slots=2,
                                         summary=radix_summary(toks)))
        r.update_replica("idle", serving(summary=radix_summary([1, 1, 1, 1])))
        assert r.route(toks).replica == "idle"

    def test_fallback_is_least_loaded(self):
        r, _ = mk_router()
        r.add_replica("a", "http://a")
        r.add_replica("b", "http://b")
        r.update_replica("a", serving(queue_depth=3))
        r.update_replica("b", serving(queue_depth=1))
        d = r.route([200, 201, 202, 203])
        assert (d.replica, d.fallback) == ("b", True)
        assert r.metrics["routed"].value("b", "fallback") == 1
        assert r.affinity_hit_rate == 0.0

    def test_stale_penalized_dead_dropped(self):
        r, clk = mk_router()
        toks = list(range(8))
        r.add_replica("old", "http://o")
        r.add_replica("new", "http://n")
        r.update_replica("old", serving(summary=radix_summary(toks)))
        clk.advance(scoring.STALE_AFTER_S + 1)
        r.update_replica("new", serving())
        assert r.route(toks).replica == "new"
        assert r.metrics["replicas"].value("stale") == 1
        clk.advance(scoring.DEAD_AFTER_S)
        d = r.route(toks)
        assert d.replica == "new" and d.candidates == 1
        assert r.metrics["skipped"].value("old", "dead") == 1
        clk.advance(scoring.DEAD_AFTER_S)
        with pytest.raises(NoReplicaError):
            r.route(toks)

    def test_breaker_open_excluded_until_cooldown(self):
        r, clk = mk_router()
        r.add_replica("flaky", "http://f")
        r.add_replica("ok", "http://k")
        r.update_replica("flaky", serving())
        r.update_replica("ok", serving(queue_depth=4))
        flaky = r.replicas()[0]
        for _ in range(3):
            flaky.breaker.record_failure()
        assert r.route([300, 301, 302, 303]).replica == "ok"
        assert r.metrics["skipped"].value("flaky", "breaker") == 1
        clk.advance(10.0)
        assert r.route([300, 301, 302, 303]).replica == "flaky"

    def test_optimistic_insert_creates_affinity_before_refresh(self):
        r, _ = mk_router()
        toks = list(range(8))
        r.add_replica("a", "http://a")
        r.add_replica("b", "http://b")
        r.update_replica("a", serving(summary=radix_summary([9, 9, 9, 9])))
        r.update_replica("b", serving(summary=radix_summary([8, 8, 8, 8])))
        first = r.route(toks)
        assert first.fallback
        r.note_routed(first, toks)
        again = r.route(toks)
        assert (again.replica, again.fallback) == (first.replica, False)
        r.update_replica(first.replica,
                         serving(summary=radix_summary([9, 9, 9, 9])))
        assert r.route(toks).fallback

    def test_route_fault_point(self):
        r, _ = mk_router()
        r.add_replica("a", "http://a")
        r.update_replica("a", serving())
        REGISTRY.arm(FaultSpec("router.route", "error", kind="timeout"))
        with pytest.raises(TimeoutError):
            r.route([1, 2, 3, 4])

    def test_route_skips_draining_replica(self):
        """tests/test_migration.py::TestRouterDraining."""
        r, _ = mk_router()
        r.add_replica("a", "http://a")
        r.add_replica("b", "http://b")
        r.update_replica("a", serving())
        r.update_replica("b", serving(queue_depth=4))
        toks = list(range(8))
        assert r.route(toks).replica == "a"
        r.mark_draining("a")
        assert r.route(toks).replica == "b"
        assert r.metrics["skipped"].value("a", "draining") >= 1
        r.update_replica("a", serving())
        assert r.route(toks).replica == "a"

    def test_prefill_pool_is_separate_and_least_loaded(self):
        r, _ = mk_router()
        r.add_replica("d0", "http://d0")
        r.add_prefill_replica("p1", "http://p1")
        r.add_prefill_replica("p0", "http://p0")
        r.update_replica("d0", serving())
        r.update_replica("p0", serving(queue_depth=4))
        r.update_replica("p1", serving())
        assert r.route_prefill().name == "p1"
        r.mark_draining("p1")
        assert r.route_prefill().name == "p0"
        with pytest.raises(NoReplicaError):
            r.route_prefill(exclude={"p0"})
        assert r.route(list(range(8))).replica == "d0"
        assert r.metrics["prefill_routed"].value("p1") == 1


class TestStoreRoundTrip:
    """servingStats over the port's heartbeat: stats dict -> NodeAgent ->
    store -> NodeState list -> router scoring."""

    def heartbeat_node(self, store, name, stats, clock, tmp_path):
        NodeAgent(store, name, gpu_capacity=8, gpu_memory_bytes=64 << 30,
                  model_root=str(tmp_path / name), clock=clock,
                  serving_stats=lambda: stats).heartbeat()

    def states(self, store):
        return [NodeState.from_dict(d) for d in store.list(NodeState.KIND)]

    def test_roundtrip_scores_from_store_view(self, tmp_path):
        store, clock = Store(), SimulatedClock(start=1000.0)
        toks = list(range(12))
        self.heartbeat_node(store, "node-warm",
                            serving(summary=radix_summary(toks)), clock,
                            tmp_path)
        self.heartbeat_node(store, "node-cold",
                            serving(summary=radix_summary([7, 7, 7, 7])),
                            clock, tmp_path)
        router = FleetRouter(clock=clock.now, device="cpu")
        router.add_replica("node-warm", "http://w:8000")
        router.add_replica("node-cold", "http://c:8000")
        router.update_from_nodestates(self.states(store), now=clock.now())
        d = router.route(toks)
        assert (d.replica, d.match_blocks) == ("node-warm", 3)

    def test_stale_heartbeat_penalized_dead_dropped(self, tmp_path):
        store, clock = Store(), SimulatedClock(start=1000.0)
        toks = list(range(12))
        self.heartbeat_node(store, "node-a",
                            serving(summary=radix_summary(toks)), clock,
                            tmp_path)
        clock.advance(scoring.STALE_AFTER_S + 5)
        self.heartbeat_node(store, "node-b", serving(), clock, tmp_path)
        router = FleetRouter(clock=clock.now, device="cpu")
        router.add_replica("node-a", "http://a:8000")
        router.add_replica("node-b", "http://b:8000")
        states = self.states(store)
        router.update_from_nodestates(states, now=clock.now())
        assert router.route(toks).replica == "node-b"
        clock.advance(scoring.DEAD_AFTER_S)
        router.update_from_nodestates(states, now=clock.now())
        d = router.route(toks)
        assert d.replica == "node-b" and d.candidates == 1

    def test_heartbeat_clamps_oversized_summary(self, tmp_path):
        store, clock = Store(), SimulatedClock(start=1000.0)
        big = serving(summary={
            "version": 1, "block_size": 4, "total_nodes": 10_000,
            "truncated": False,
            "fingerprints": list(range(SUMMARY_FINGERPRINT_BUDGET + 100)),
        })
        self.heartbeat_node(store, "node-big", big, clock, tmp_path)
        state = NodeState.from_dict(store.get(NodeState.KIND, "node-big"))
        got = state.serving_stats["cache_summary"]
        assert got["fingerprints"] == list(range(SUMMARY_FINGERPRINT_BUDGET))
        assert got["truncated"] is True
        assert len(big["cache_summary"]["fingerprints"]) == \
            SUMMARY_FINGERPRINT_BUDGET + 100


# --- tests/test_router_solver.py TestStormBatcher, TestTokenizerPath -------


class TestStormBatcher:
    def plant(self):
        r, _ = mk_router()
        toks_a, toks_b = list(range(16)), list(range(50, 66))
        for name, toks in [("a", toks_a), ("b", toks_b)]:
            r.add_replica(name, f"http://{name}")
            r.update_replica(name, serving(summary=summary_of(toks)))
        return r, toks_a, toks_b

    def test_concurrent_arrivals_share_one_solve(self):
        r, toks_a, toks_b = self.plant()
        sb = _StormBatcher(r, window_s=0.05)
        results: dict[int, object] = {}

        def go(i):
            results[i] = sb.route(toks_a if i % 2 == 0 else toks_b,
                                  frozenset())

        threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10.0)
        assert len(results) == 8
        for i, d in results.items():
            assert d.replica == ("a" if i % 2 == 0 else "b")
        assert r.metrics["batch_size"].value() > 1
        assert r.metrics["solver_routed"].value("parity") == 8

    def test_empty_fleet_returns_none_for_fallback(self):
        r, _ = mk_router()
        assert _StormBatcher(r, window_s=0.01).route([1, 2, 3, 4],
                                                     frozenset()) is None


class _StubTokenizer:
    def __init__(self, fail=False):
        self.fail = fail

    def encode(self, text: str) -> list[int]:
        if self.fail:
            raise RuntimeError("boom")
        return [ord(c) % 251 for c in text]


TEXT = "hello world, again and again"


class TestTokenizerPath:
    def mk_server(self, tokenizer=None, **kw):
        r, _ = mk_router()
        r.add_replica("warm", "http://warm")
        r.add_replica("cold", "http://cold")
        r.update_replica("warm", serving(summary=summary_of(
            _StubTokenizer().encode(TEXT))))
        r.update_replica("cold", serving(summary=summary_of([9] * 8)))
        srv = RouterServer(r, poll_interval_s=0, tokenizer=tokenizer, **kw)
        # no sockets: the proxy leg is stubbed
        srv._proxy = lambda decision, raw: b'{"choices": []}'
        return srv, r

    def forward(self, srv, body):
        code, payload = srv.forward(json.dumps(body).encode())
        return code, json.loads(payload)

    def test_string_prompt_fingerprint_matches_with_tokenizer(self):
        srv, r = self.mk_server(tokenizer=_StubTokenizer())
        code, doc = self.forward(srv, {"prompt": TEXT, "max_tokens": 4})
        assert code == 200 and doc["kubeinfer"]["replica"] == "warm"
        assert doc["kubeinfer"]["match_blocks"] > 0
        assert r.metrics["tokenizer_fallback"].value() == 0

    def test_tokenizer_feeds_optimistic_note_routed(self):
        srv, r = self.mk_server(tokenizer=_StubTokenizer())

        def warm_fps():
            return len(next(v for v in r.replicas()
                            if v.name == "warm").fingerprints)

        before = warm_fps()
        self.forward(srv, {"prompt": TEXT[:12] + " AND SOMETHING NEW HERE!",
                           "max_tokens": 4})
        assert warm_fps() > before

    @pytest.mark.parametrize("tokenizer", [None, _StubTokenizer(fail=True)],
                             ids=["none", "encode-fails"])
    def test_fallback_counted_and_served(self, tokenizer):
        srv, r = self.mk_server(tokenizer=tokenizer)
        code, _ = self.forward(srv, {"prompt": TEXT})
        assert code == 200
        assert r.metrics["tokenizer_fallback"].value() == 1

    def test_storm_window_first_placement(self):
        srv, r = self.mk_server(tokenizer=_StubTokenizer(),
                                storm_window_s=0.02)
        code, doc = self.forward(srv, {"prompt": TEXT, "max_tokens": 4})
        assert code == 200 and doc["kubeinfer"]["replica"] == "warm"
        assert r.metrics["solver_routed"].value("parity") >= 1

    def test_bad_json_and_unknown_path_verdicts(self):
        srv, _ = self.mk_server()
        code, payload = srv.forward(b"{not json")
        assert code == 400
        assert json.loads(payload)["error"]["type"] == \
            "invalid_request_error"
