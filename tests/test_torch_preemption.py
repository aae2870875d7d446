"""SLO-aware preemption and load shedding of the port's continuous batcher
(``ContinuousEngine(preemption=..., queue_depth_limit=...)``) against the
JAX package's, on the CPU, ``tiny`` with the reference's parameters
carried across (``weights.params_from_reference``), 2 slots, blocks of 8.

The cases follow ``tests/test_inference_chunked_prefill.py::
TestPreemption``, ``tests/test_inference_multistep.py`` (parks at window
boundaries) and ``tests/test_inference_spec_verify.py`` (preemption
cycles on verify windows), under the reference tests' aggressive policy:

- ``PreemptionPolicy.parse`` equal to the reference's on every spec.
- Token identity: under sustained parking, every stream of the port,
  greedy and sampled, on the bf16 and the int8 pool, EQUALS the JAX
  engine's uncontended stream and the port's own (f32 on the CPU, so no
  tolerance: the position-folded key schedule makes a readmit draw the
  noise an uninterrupted run draws).
- A block-aligned park (the newest token opens a block): the park caches
  only the blocks fully below it, the readmit is identical, and a longer
  continuation that reuses the cached blocks gives the JAX engine's
  stream under the same park (a cached block with an unwritten last
  position would change it).
- 12 requests through 2 slots finish with their full budgets (no
  livelock); parks against fused windows (``max_window=8``) and against
  verify windows keep every stream.
- Shedding: ``EngineOverloadedError`` with the refused request marked
  ``"shed"``, as the reference refuses, and over HTTP 503 ``overloaded``
  with ``Retry-After`` >= 1; twelve threads submitting past the limit
  under parking lose no request.

Every wait carries its own timeout.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import batching as jb
from kubeinfer_tpu_torch.inference import batching as tb
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.engine import Engine

JT, TT = JP["tiny"], TP["tiny"]
BS = 8
# a hung scheduler fails the test instead of the run: the slowest case
# (the module's uncontended references) takes about 35 s under 6 xdist
# workers
WAIT_S = 120


def aggressive(pkg):
    """The reference tests' policy: a 2-slot engine under a backlog parks
    within a few decode steps; min_progress and cooldown stay nonzero."""
    return pkg.PreemptionPolicy(threshold_s=0.0005, objective=0.5,
                                burn_limit=0.5, cooldown_steps=1,
                                min_progress=1)


def conv(p):
    return tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def params():
    p = j_init(JT, jax.random.PRNGKey(6))
    d = j_init(dataclasses.replace(JT, num_hidden_layers=1),
               jax.random.PRNGKey(7))  # an unrelated 1-layer draft
    return p, conv(p), d, conv(d)


def j_engine(params, **kw):
    kw = dict(n_slots=2, cache_len=64, block_size=BS, **kw)
    return jb.ContinuousEngine(params[0], JT, **kw).start()


def t_engine(params, **kw):
    kw = dict(n_slots=2, cache_len=64, block_size=BS, **kw)
    return tb.ContinuousEngine(params[1], TT, device="cpu", **kw).start()


def run(eng, jobs, new):
    """Every job submitted at once, then each completion awaited."""
    reqs = [eng.submit(p, new, **kw) for p, kw in jobs]
    for i, r in enumerate(reqs):
        assert r.done.wait(WAIT_S), f"request {i} starved"
        assert not r.failed, r.failed
    return [r.out_tokens for r in reqs]


def solo(eng, jobs, new):
    return [eng.generate(p, new, timeout=WAIT_S, **kw) for p, kw in jobs]


# --- the policy --------------------------------------------------------------


@pytest.mark.parametrize("spec", ["0.25", "0.25:2.0", "1", "0.5:0.5",
                                  "0.25:2.0:9", "x", "0.5:y"])
def test_parse_matches_reference(spec):
    def parse(pkg):
        try:
            return dataclasses.asdict(pkg.PreemptionPolicy.parse(spec))
        except ValueError as e:
            return ("ValueError", "THRESHOLD_S" in str(e))

    assert parse(tb) == parse(jb)


def test_policy_defaults_and_monitor_match_reference(params):
    assert dataclasses.asdict(tb.PreemptionPolicy()) == \
        dataclasses.asdict(jb.PreemptionPolicy())
    eng = tb.ContinuousEngine(params[1], TT, n_slots=2, cache_len=64,
                              device="cpu", preemption=aggressive(tb))
    obj = eng._slo.objectives["queue_wait"]
    assert (obj.threshold_s, obj.objective) == (0.0005, 0.5)
    assert eng._slo.windows == (30.0, 300.0)
    with pytest.raises(ValueError, match="migration_chunk_blocks"):
        tb.ContinuousEngine(params[1], TT, cache_len=64, device="cpu",
                            migration_chunk_blocks=0)


# --- token identity under parking --------------------------------------------

PROMPTS = [[i + 1, i + 2, i + 3, i + 4, i + 5] for i in range(8)]
SAMPLED = dict(temperature=0.9, top_k=11)
JOBS = [(p, {}) for p in PROMPTS] + [
    (p, dict(seed=100 + i, **SAMPLED)) for i, p in enumerate(PROMPTS)]


@pytest.fixture(scope="module")
def uncontended(params):
    """Per pool: the JAX engine's and the port's uncontended streams of
    JOBS (one request at a time), 10 new tokens each."""
    out = {}
    for kv in ("bf16", "int8"):
        row = {}
        for name, mk in (("jax", j_engine), ("port", t_engine)):
            eng = mk(params, kv_dtype=kv)
            try:
                row[name] = solo(eng, JOBS, 10)
            finally:
                eng.stop()
        out[kv] = row
    return out


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_preempt_resume_identity(params, uncontended, kv):
    """The warm-resume contract: under sustained preemption every stream,
    greedy and sampled, equals the uncontended ones of both packages."""
    want = uncontended[kv]
    assert want["port"] == want["jax"]
    eng = t_engine(params, kv_dtype=kv, preemption=aggressive(tb))
    try:
        got = run(eng, JOBS, 10)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    # the scenario must exercise the mechanism, else the identity below
    # would pass vacuously
    assert stats["preempted"] > 0
    assert stats["resumed"] == stats["preempted"]
    assert stats["parked"] == 0
    for i, (g, w) in enumerate(zip(got, want["jax"])):
        assert g == w, f"{'greedy' if i < 8 else 'sampled'} {i % 8}"


def aligned_park(cls):
    """``cls`` whose preemption check parks a decoding row ONCE, at the
    first boundary where its newest token opens a block (prompt + output
    a multiple of the block size), and readmits it at once."""

    class Aligned(cls):
        parked_at = None

        def _maybe_preempt(self):
            if self.parked_at is not None:
                return
            with self._lock:
                prefilling = {t.slot for t in self._prefills}
                for slot, req in enumerate(self._slot_req):
                    n = len(req.prompt) + len(req.out_tokens) if req else 0
                    if req is None or slot in prefilling or \
                            not req.out_tokens or n % self.block_size:
                        continue
                    self.parked_at = n
                    self._park_slot(slot)
                    break
            if self.parked_at is not None:
                self._admit_pending()

    return Aligned


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_block_aligned_park(params, kv):
    """A park where the newest token opens a block: only the blocks fully
    below it enter the trie, the readmit is identical to the uncontended
    run, and a longer continuation that reuses the cached blocks gives
    the JAX engine's stream under the same park."""
    prompt = np.random.default_rng(21).integers(0, 256, 13).tolist()
    cont = prompt + [7, 3, 9, 11, 2, 5, 4, 8, 1, 6, 10]  # 24: 3 blocks
    got = {}
    for name, pkg, mk in (("jax", jb, j_engine), ("port", tb, t_engine)):
        plain = mk(params, kv_dtype=kv)
        try:
            want = plain.generate(prompt, 12, timeout=WAIT_S)
        finally:
            plain.stop()
        kw = dict(n_slots=2, cache_len=64, block_size=BS, kv_dtype=kv,
                  max_window=1, preemption=aggressive(pkg))
        cls = aligned_park(pkg.ContinuousEngine)
        eng = (cls(params[0], JT, **kw) if name == "jax" else
               cls(params[1], TT, device="cpu", **kw)).start()
        try:
            out = eng.generate(prompt, 12, timeout=WAIT_S)
            assert eng.parked_at == 16 and eng.preempted_total == 1
            assert eng.resumed_total == 1
            assert out == want
            after = eng.generate(cont, 4, timeout=WAIT_S)
            stats = eng.kv_cache_stats()
        finally:
            eng.stop()
        got[name] = (out, after, stats["hits"], stats["nodes"])
    assert got["port"] == got["jax"]


def test_oversubscribed_no_livelock(params):
    """12 requests through 2 slots with preemption firing at every
    opportunity: every request retires with its full budget, and the
    engine ends with nothing parked and nothing mid-prefill."""
    rng = np.random.default_rng(9)
    jobs = [(rng.integers(0, 256, 6).tolist(),
             dict(temperature=0.7 if i % 2 else 0.0, seed=i))
            for i in range(12)]
    eng = t_engine(params, preemption=aggressive(tb))
    try:
        got = run(eng, jobs, 8)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert all(len(g) == 8 for g in got)
    assert stats["preempted"] > 0
    assert stats["parked"] == 0 and stats["chunk_queue"] == 0


def test_preemption_lands_at_window_boundaries(params):
    """Park cycles against fused windows (max_window=8): parks happen only
    between windows (the check runs at a pass's top), so every request,
    parked, readmitted, parked again, still emits the uncontended
    stream of the JAX engine."""
    rng = np.random.default_rng(14)
    jobs = [(rng.integers(0, 256, 5).tolist(),
             dict(temperature=0.8 if i % 2 else 0.0, seed=50 + i,
                  top_k=9 if i % 2 else 0)) for i in range(16)]
    ref = j_engine(params, max_window=8)
    try:
        want = solo(ref, jobs, 10)
    finally:
        ref.stop()
    eng = t_engine(params, max_window=8, preemption=aggressive(tb))
    try:
        got = run(eng, jobs, 10)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert stats["preempted"] >= 20, f"only {stats['preempted']} park cycles"
    assert stats["resumed"] == stats["preempted"]
    assert got == want


def test_identity_across_preemption_cycles_on_verify_windows(params):
    """Park/readmit cycles against verify windows (a 1-layer draft,
    spec_k 4): a park drops the row's draft state and verify slack, the
    readmit re-arms both, and every stream equals the JAX plain engine's
    (one token a window)."""
    rng = np.random.default_rng(44)
    jobs = [(rng.integers(0, 256, 5).tolist(),
             dict(temperature=0.8 if i % 2 else 0.0, seed=70 + i,
                  top_k=9 if i % 2 else 0)) for i in range(12)]
    ref = j_engine(params, max_window=1)
    try:
        want = solo(ref, jobs, 8)
    finally:
        ref.stop()
    draft = (params[3], dataclasses.replace(TT, num_hidden_layers=1))
    eng = t_engine(params, spec_draft=draft, spec_k=4,
                   preemption=aggressive(tb))
    try:
        got = run(eng, jobs, 8)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert stats["preempted"] >= 1, "the policy never parked anything"
    assert stats["resumed"] == stats["preempted"]
    assert stats["spec_draft_tokens"] > 0
    assert got == want


# --- load shedding -----------------------------------------------------------


def test_submit_sheds_past_limit(params):
    """Engines not started, so submits stay queued: the third submit over
    a limit of 2 is refused in both packages, with a retry hint, and the
    port's refused request is complete and marked "shed"."""
    for pkg, p, cfg, kw in ((jb, params[0], JT, {}),
                            (tb, params[1], TT, dict(device="cpu"))):
        eng = pkg.ContinuousEngine(p, cfg, n_slots=2, cache_len=64,
                                   block_size=BS, queue_depth_limit=2, **kw)
        assert eng.queue_depth_limit == 2
        eng.submit([1, 2, 3], 4)
        eng.submit([1, 2, 3], 4)
        with pytest.raises(pkg.EngineOverloadedError) as ei:
            eng.submit([1, 2, 3], 4)
        assert ei.value.retry_after_s > 0
        eng.stop()
    shed = ei.value.request
    assert shed.failed == "shed" and shed.done.is_set()
    assert not shed.out_tokens


def test_parked_rows_count_toward_the_limit(params):
    eng = tb.ContinuousEngine(params[1], TT, n_slots=2, cache_len=64,
                              block_size=BS, queue_depth_limit=2,
                              device="cpu")
    eng._parked.append(tb._Request([1, 2], 4, -1))
    eng._holdover.append(tb._Request([1, 2], 4, -1))
    with pytest.raises(tb.EngineOverloadedError, match="queue depth 2"):
        eng.submit([1, 2, 3], 4)
    eng.stop()


def test_server_answers_503_overloaded_with_retry_after(params):
    """One queued request fills a limit of 1 (engine not started): the
    HTTP request is refused at once with 503 ``overloaded`` and a
    Retry-After of at least one second; once the scheduler runs, the
    queue drains and the same body is served."""
    eng = tb.ContinuousEngine(params[1], TT, n_slots=2, cache_len=64,
                              block_size=BS, queue_depth_limit=1,
                              device="cpu")
    queued = eng.submit([1, 2, 3], 4)
    srv = ts.InferenceServer(Engine(params[1], TT, device="cpu"), "tiny",
                             port=0, continuous=eng, device="cpu").start()
    body = json.dumps({"prompt": [1, 2, 3], "max_tokens": 2}).encode()
    url = f"http://127.0.0.1:{srv.port}/v1/completions"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url, data=body, timeout=60)
        assert ei.value.code == 503
        assert int(ei.value.headers["Retry-After"]) >= 1
        assert json.loads(ei.value.read())["error"]["type"] == "overloaded"
        eng.start()
        assert queued.done.wait(WAIT_S) and not queued.failed
        with urllib.request.urlopen(url, data=body, timeout=60) as r:
            assert r.status == 200
            assert len(json.loads(r.read())["choices"][0]["tokens"]) == 2
    finally:
        srv.stop()
        eng.stop()


def test_preemption_flags_build_the_engine():
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0", "--batch-slots",
         "2", "--max-model-len", "128", "--preemption-slo", "0.25:2.0",
         "--queue-depth-limit", "3", "--migration-chunk-blocks", "2"],
        device="cpu")
    try:
        assert cont.preemption == tb.PreemptionPolicy(threshold_s=0.25,
                                                      burn_limit=2.0)
        assert cont.queue_depth_limit == 3
        assert cont.migration_chunk_blocks == 2
        assert cont.migration_sink == srv._export_migration_chunk
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="THRESHOLD_S"):
        ts.build_server(["--model", "tiny", "--random-init",
                         "--preemption-slo", "1:2:3"], device="cpu")


def test_threads_submitting_past_the_limit(params):
    """Twelve threads against 2 slots under the policy and a depth limit
    of 3, with a short switch interval: every submit either is refused
    (its request marked "shed") or completes with its full budget, and
    the engine ends with every park readmitted and nothing parked."""
    eng = t_engine(params, preemption=aggressive(tb), queue_depth_limit=3)
    out = [None] * 12

    def client(i):
        p = np.random.default_rng(i).integers(0, 256, 5 + i).tolist()
        try:
            out[i] = eng.serve(p, 6, seed=i, timeout=WAIT_S)
        except tb.EngineOverloadedError as e:
            out[i] = e

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=WAIT_S)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    shed = [o for o in out if isinstance(o, tb.EngineOverloadedError)]
    served = [o for o in out if not isinstance(o, tb.EngineOverloadedError)]
    assert len(shed) + len(served) == 12 and served
    assert all(e.request.failed == "shed" for e in shed)
    assert all(len(r.out_tokens) == 6 and not r.failed for r in served)
    stats = eng.scheduler_stats()
    assert stats["resumed"] == stats["preempted"] and stats["parked"] == 0
