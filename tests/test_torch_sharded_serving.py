"""Tensor-parallel serving in the port (``ContinuousEngine(layout=...)``,
the sharded ``Engine``, ``SpeculativeEngine`` and server) against the
JAX package's tp engine on its 8 virtual CPU devices and against the
port's own tp=1 engine, on the CPU: ``tiny`` (4 heads, 2 KV heads) and a
GQA shape (8 heads, 4 KV heads), the reference's parameters carried
across (``weights.params_from_reference``), the port's tp ranks a mesh of
repeated ``cpu`` devices.

Token streams are EQUAL (f32: the all-reduce reorders partial sums by a
few ulps, and every pick rides a logit gap, as the reference's
``EngineLayout`` docstring argues), cold, sampled and warm (a radix hit),
as ``tests/test_inference_sharded_serving.py:_streams``:

- tp=2 against the reference at tp=2 and the port at tp=1;
- the GQA shape at tp 1, 2 and 4 (n_kv == tp, one KV head a rank)
  against the reference at tp=1;
- under preemption (park and warm readmit through the sharded pool), on
  the int8 pool with int8 weights, and on the verify route (the draft
  replicated), against the port at tp=1;
- the per-request ``Engine`` and the draft-group ``SpeculativeEngine``
  over sharded target and draft.

The KV wire is layout-blind: pages imported into a tp=2 pool (split
along n_kv) come back out of its export capture and its drain's
migration chunk BITWISE the tp=1 engine's, bf16 and int8. The server
takes ``--tensor-parallel-size 2 --device cpu`` and answers over HTTP
with ``kubeinfer_engine_tp_degree`` and ``kubeinfer_mesh_devices`` 2.
"""

from __future__ import annotations

import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu.inference.config import ModelConfig as JCfg
from kubeinfer_tpu.inference.sharding import EngineLayout as JLayout
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.batching import PreemptionPolicy
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.config import ModelConfig as TCfg
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.sharding import (
    EngineLayout,
    Sharded,
    ShardedParams,
    make_inference_mesh,
    shard_params,
)
from kubeinfer_tpu_torch.inference.speculative import SpeculativeEngine

from test_torch_migration import drain_when_ready, gated

TINY = TP["tiny"]
GQA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4, max_position_embeddings=512)
AGGRESSIVE = dict(threshold_s=0.0005, objective=0.5, burn_limit=0.5,
                  cooldown_steps=1, min_progress=1)
WAIT_S = 60


def layout(tp):
    return EngineLayout.build(tp, ["cpu"] * tp)


@pytest.fixture(scope="module")
def params():
    p = j_init(JP["tiny"], jax.random.PRNGKey(6))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def port(tparams, cfg=TINY, tp=1, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("block_size", 8)
    return TC(tparams, cfg, device="cpu",
              layout=layout(tp) if tp > 1 else None, **kw).start()


def streams(eng, prompt, n=9):
    """Cold greedy, sampled, then a warm (radix-hit) readmit."""
    try:
        return (eng.generate(prompt, n),
                eng.generate(prompt, n, temperature=0.8, seed=5, top_k=13),
                eng.generate(prompt, n))
    finally:
        eng.stop()


def test_tp2_matches_reference_tp2_and_tp1(params):
    jp, tparams = params
    prompt = np.random.default_rng(21).integers(0, 256, 7).tolist()
    want = streams(JC(jp, JP["tiny"], n_slots=2, cache_len=64, block_size=8,
                      max_window=8, layout=JLayout.build(2)).start(), prompt)
    eng = port(tparams, tp=2, max_window=8)
    st = eng._state
    assert isinstance(eng.params, ShardedParams) and st.sharded
    assert [tuple(p.shape) for p in st.caches_k[0]] == [(33, 8, 1, 16)] * 2
    assert tuple(st.caches_k[0].shape) == (33, 8, 2, 16)
    stats = eng.stats_summary()
    assert stats["tp_degree"] == 2 and stats["mesh_devices"] == 2
    assert streams(eng, prompt) == want
    assert streams(port(tparams, max_window=8), prompt) == want


@pytest.fixture(scope="module")
def gqa():
    jp = j_init(JCfg(**GQA), jax.random.PRNGKey(7))
    prompt = np.random.default_rng(22).integers(0, 256, 6).tolist()
    want = streams(JC(jp, JCfg(**GQA), n_slots=2, cache_len=64,
                      block_size=8, max_window=4).start(), prompt, n=7)
    return (tw.params_from_reference(jax.tree.map(np.asarray, jp), "cpu"),
            prompt, want)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_gqa_ratios_divide_and_equal(gqa, tp):
    tparams, prompt, want = gqa
    assert streams(port(tparams, TCfg(**GQA), tp=tp, max_window=4), prompt,
                   n=7) == want


def test_preemption_parity_under_sharding(params):
    _, tparams = params
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 256, 5).tolist() for _ in range(8)]

    def kw(i):
        return dict(temperature=0.8 if i % 2 else 0.0, seed=50 + i,
                    top_k=9 if i % 2 else 0)

    solo = port(tparams, max_window=8)
    try:
        want = [solo.generate(p, 8, **kw(i)) for i, p in enumerate(prompts)]
    finally:
        solo.stop()
    eng = port(tparams, tp=2, max_window=8,
               preemption=PreemptionPolicy(**AGGRESSIVE))
    try:
        reqs = [eng.submit(p, 8, **kw(i)) for i, p in enumerate(prompts)]
        for r in reqs:
            assert r.done.wait(WAIT_S) and not r.failed
        assert eng.preempted_total >= 1, "the policy never parked"
    finally:
        eng.stop()
    assert [r.out_tokens for r in reqs] == want


def test_int8_pool_and_weights_under_sharding(params):
    _, tparams = params
    prompt = np.random.default_rng(24).integers(0, 256, 11).tolist()
    kw = dict(kv_dtype="int8", weight_dtype="int8", max_window=4)
    want = streams(port(tparams, **kw), prompt, n=12)
    eng = port(tparams, tp=2, **kw)
    st = eng._state
    assert st.quantized and isinstance(st.q8_pages, Sharded)
    assert [tuple(p.shape) for p in st.q8_scales] == [(2, 2, 33, 1)] * 2
    # column-parallel codes and scales split on the out axis, row-parallel
    # codes on the in axis with the whole scale
    q = eng.params.shards[1]["layers"][0]
    assert tuple(q["q_proj"]["qw"].shape) == (64, 32)
    assert tuple(q["q_proj"]["scale"].shape) == (32,)
    assert tuple(q["down_proj"]["qw"].shape) == (64, 64)
    assert tuple(q["down_proj"]["scale"].shape) == (64,)
    assert streams(eng, prompt, n=12) == want


def test_spec_verify_under_sharding(params):
    _, tparams = params
    mesh = make_inference_mesh(tp=2, sp=1, dp=1, devices=["cpu"] * 2)
    dparams = shard_params(tparams, mesh, TINY)  # a self draft
    prompt = np.random.default_rng(45).integers(0, 256, 7).tolist()
    want = streams(port(tparams, max_window=1), prompt, n=8)
    eng = TC(tparams, TINY, n_slots=2, cache_len=64, block_size=8,
             device="cpu", layout=EngineLayout(tp=2, mesh=mesh),
             spec_draft=(dparams, TINY), spec_k=4).start()
    # the verify route's draft is replicated: one plain tree
    assert isinstance(eng._dparams, dict)
    got = streams(eng, prompt, n=8)
    assert got == want
    assert eng.scheduler_stats()["spec_draft_tokens"] > 0
    assert {r.bucket for r in eng.profiler.snapshot()
            if r.phase == "verify"} == {4}


def test_engine_and_speculative_over_sharded_params(params):
    _, tparams = params
    mesh = make_inference_mesh(tp=2, sp=1, dp=1, devices=["cpu"] * 2)
    sp = shard_params(tparams, mesh, TINY)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9]]
    kw = dict(temperature=0.7, seed=3, top_k=20)
    want = Engine(tparams, TINY, device="cpu").generate(prompts, 8, **kw)
    got = Engine(sp, TINY, device="cpu").generate(prompts, 8, **kw)
    assert np.array_equal(got.tokens, want.tokens)
    want = SpeculativeEngine(tparams, TINY, tparams, TINY,
                             device="cpu").generate(prompts, 8)
    got = SpeculativeEngine(sp, TINY, sp, TINY, device="cpu").generate(
        prompts, 8)
    assert np.array_equal(got.tokens, want.tokens)


def blocks_of(req):
    ex = req.kv_export
    return {k: ex[k] for k in ("pages_k", "pages_v", "scales_k", "scales_v")
            if k in ex}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_wire_bytes_are_layout_blind(params, kv):
    """Three full blocks exported by a tp=1 engine land in a tp=1 and a
    tp=2 pool; both engines' export captures, and the drain chunk of a
    session that admits warm over them (held at a window boundary until
    the drain, one token a window, so its committed blocks are the
    imported three), are bitwise equal."""
    from kubeinfer_tpu_torch.disagg import wire

    _, tparams = params
    prompt = np.random.default_rng(31).integers(0, 256, 25).tolist()
    src = port(tparams, kv_dtype=kv, cache_len=64, block_size=8)
    try:
        req = src.submit(prompt, 1, export_kv=True)
        assert req.done.wait(WAIT_S) and not req.failed
        pages = blocks_of(req)
    finally:
        src.stop()
    assert pages["pages_k"].shape[1] == 3
    got = []
    for tp in (1, 2):
        eng = gated(TC, 2)(tparams, TINY, n_slots=2, cache_len=64,
                           block_size=8, max_window=1, kv_dtype=kv,
                           migration_chunk_blocks=4, device="cpu",
                           layout=layout(tp) if tp > 1 else None)
        eng.ready, eng.go = threading.Event(), threading.Event()
        chunks = []
        eng.migration_sink = chunks.append
        eng.start()
        try:
            n, reason = eng.import_prefix(prompt[:24], kv_dtype=kv, **pages)
            assert (n, reason) == (3, None)
            req = eng.submit(prompt, 1, export_kv=True)
            assert req.done.wait(WAIT_S) and not req.failed
            sess = eng.submit(prompt, 30)
            drain_when_ready(eng)
            assert eng.wait_drained(WAIT_S) and sess.done.wait(WAIT_S)
        finally:
            eng.go.set()
            eng.stop()
        assert sess.migrated is not None and len(chunks) == 1
        c = chunks[0]
        got.append((blocks_of(req), wire.encode_payload(
            c["pages_k"], c["pages_v"], c["fingerprints"], c["block_size"],
            scales_k=c.get("scales_k"), scales_v=c.get("scales_v"),
            kv_dtype=c.get("kv_dtype", "bf16"),
            start_block=c["start_block"])))
    (ex1, blob1), (ex2, blob2) = got
    assert ex1.keys() == ex2.keys() == pages.keys()
    for k in pages:
        assert torch.equal(ex1[k], pages[k]) and torch.equal(ex2[k], ex1[k])
    assert blob1 == blob2


def post(port_, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port_}/v1/completions",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    return json.loads(urllib.request.urlopen(req, timeout=WAIT_S).read())


def test_server_tensor_parallel_over_http(params):
    """``--tensor-parallel-size 2 --device cpu``: a 2-rank CPU mesh for
    the batcher, the per-request engine and the draft; a batcher request
    and an engine-route request (``--batch-slots 0``) answer the tp=1
    streams, and the gauges read 2."""
    flags = ["--model", "tiny", "--random-init", "--port", "0", "--host",
             "127.0.0.1", "--max-model-len", "256", "--batch-slots", "2"]
    body = dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6], max_tokens=6)
    answers = []
    for tp in ("1", "2"):
        for slots in ("2", "0"):
            argv = flags[:-1] + [slots, "--tensor-parallel-size", tp,
                                 "--draft-model", "tiny"]
            srv, cont = ts.build_server(argv, device="cpu")
            if cont is not None:
                cont.start()
            srv.start()
            try:
                out = post(srv.port, body)
                answers.append((out["kubeinfer"]["route"],
                                out["choices"][0]["tokens"]))
                text = urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/metrics",
                    timeout=WAIT_S).read().decode()
            finally:
                srv.stop()
                if cont is not None:
                    cont.stop()
            if tp == "2":
                assert isinstance(srv.engine.params, ShardedParams)
                assert isinstance(srv.speculative.draft_params,
                                  ShardedParams)
            if tp == "2" and slots == "2":
                lines = text.splitlines()
                assert "kubeinfer_engine_tp_degree 2" in lines
                assert "kubeinfer_mesh_devices 2" in lines
    assert [a[0] for a in answers] == ["continuous", "speculative"] * 2
    assert answers[2:] == answers[:2]
    with pytest.raises(ValueError, match="tp axis|mesh"):
        ts.build_server(flags + ["--tensor-parallel-size", "2"],
                        device="cpu", mesh=make_inference_mesh(
                            tp=4, sp=1, dp=1, devices=["cpu"] * 4))
