"""The port's sequence parallelism against the JAX package's, on the CPU:
``ring_attention.py``, ``sharding.forward_sequence_parallel``,
``sp_engine.py`` (``sp_prefill``'s handoff and next logits,
``SPEngine.generate``) and the server's ``"sp"`` route. The reference
runs its ``shard_map`` bodies on its 8 virtual CPU devices, the port its
layer-major ring over sp (and sp x tp) ranks of repeated ``cpu``
devices; ``tiny`` (4 heads, 2 KV heads) with the reference's parameters
carried across (``weights.params_from_reference``).

Tolerances (f32): ring attention within 1e-5 of the reference's ring,
logits within 2e-4 (the reference's own tests), token streams equal,
greedy, sampled and ragged.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as JP_

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import sharding as js
from kubeinfer_tpu.inference.ring_attention import ring_attention as j_ring
from kubeinfer_tpu.inference.sp_engine import SPEngine as JSP
from kubeinfer_tpu.inference.sp_engine import sp_prefill as j_sp_prefill
from kubeinfer_tpu.utils.jaxcompat import shard_map
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import server as tsrv
from kubeinfer_tpu_torch.inference import sharding as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.engine import (
    Engine,
    chunked_prefill,
    make_caches,
    prepare_prompts,
)
from kubeinfer_tpu_torch.inference.ring_attention import ring_attention
from kubeinfer_tpu_torch.inference.server import InferenceServer
from kubeinfer_tpu_torch.inference.sp_engine import SPEngine, sp_prefill
from kubeinfer_tpu_torch.inference.speculative import SpeculativeEngine

TINY = TP["tiny"]
CPU = ["cpu"] * 8


def t(a):
    return torch.from_numpy(np.array(a))


def mesh(tp=1, sp=2):
    return ts.make_inference_mesh(tp=tp, sp=sp, dp=1, devices=CPU)


def prompt(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, TINY.vocab_size, n).astype(np.int32).tolist()


@pytest.fixture(scope="module")
def params():
    jp = j_init(JP["tiny"], jax.random.PRNGKey(0))
    return jp, tw.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def tied():
    cfg = dataclasses.replace(TINY, tie_word_embeddings=True)
    p = tm.init_params(cfg, seed=4, device="cpu")
    p.pop("lm_head", None)
    return cfg, p


@pytest.mark.parametrize("P,causal", [(2, True), (4, True), (4, False)])
def test_ring_attention_matches_reference(P, causal):
    rng = np.random.default_rng(P)
    B, T, H, KV, D = 2, 8 * P, 4, 2, 16
    q, k, v = (rng.standard_normal((B, T, n, D)).astype(np.float32)
               for n in (H, KV, KV))
    jmesh = JMesh(np.asarray(jax.devices()[:P]), ("sp",))
    spec = JP_(None, "sp")
    want = np.asarray(jax.jit(shard_map(
        functools.partial(j_ring, axis_name="sp", causal=causal),
        mesh=jmesh, in_specs=(spec,) * 3, out_specs=spec))(q, k, v))
    n = T // P
    blocks = [[t(a[:, r * n:(r + 1) * n]) for r in range(P)]
              for a in (q, k, v)]
    got = torch.cat(ring_attention(*blocks, causal=causal), dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    # and the dense attention over the whole sequence
    mask = torch.ones((B, T, T), dtype=torch.bool)
    if causal:
        mask = torch.tril(mask)
    dense = tm.attention(t(q), t(k), t(v), mask).numpy()
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("tp", [1, 2])
def test_forward_sequence_parallel_matches_reference(params, tp):
    jp, tparams = params
    toks = np.random.default_rng(3).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(js.forward_sequence_parallel(
        jp, jnp.asarray(toks), JP["tiny"],
        js.make_inference_mesh(tp=1, sp=2)))
    got = ts.forward_sequence_parallel(tparams, t(toks).long(), TINY,
                                       mesh(tp=tp)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="must divide by sp=2"):
        ts.forward_sequence_parallel(tparams, t(toks[:, :15]).long(), TINY,
                                     mesh(tp=tp))
    assert ts.param_specs_replicated(TINY, tparams) == \
        jax.tree.map(lambda _: (), js.param_specs_replicated(
            JP["tiny"], jp), is_leaf=lambda x: isinstance(x, JP_))


@pytest.mark.parametrize("tp", [1, 2])
def test_sp_prefill_handoff_matches_chunked_and_reference(params, tp):
    jp, tparams = params
    padded, lens, cache_len = prepare_prompts([prompt(40), prompt(23, 1)],
                                              8, 512)
    # jitted, as the reference's SPEngine runs it (eager shard_map
    # dispatches op by op)
    jcaches, jlogits = jax.jit(j_sp_prefill, static_argnums=(3, 4))(
        jp if tp == 1 else js.shard_params(
            jp, js.make_inference_mesh(tp=2, sp=2), JP["tiny"]),
        jnp.asarray(padded), jnp.asarray(lens), JP["tiny"],
        js.make_inference_mesh(tp=tp, sp=2))
    m = mesh(tp=tp)
    caches, logits = sp_prefill(tparams, t(padded).long(), t(lens), TINY, m)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=2e-4, atol=2e-4)
    ref = make_caches(TINY, 2, cache_len, torch.float32, "cpu")
    ref, ref_logits = chunked_prefill(tparams, t(padded).long(), t(lens),
                                      TINY, ref, 16)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(),
                               rtol=2e-4, atol=2e-4)
    for (k, v), (rk, rv), (jk, jv) in zip(caches, ref, jcaches):
        for got, want, jwant in ((k, rk, jk), (v, rv, jv)):
            if tp > 1:
                assert isinstance(got, ts.Sharded) and len(got) == 2
                got = torch.cat(list(got), dim=2)
            assert got.shape[1] == padded.shape[1]
            for b, n in enumerate(lens):
                # only real positions take part in decode attention
                np.testing.assert_allclose(got[b, :n].numpy(),
                                           want[b, :n].numpy(),
                                           rtol=2e-4, atol=2e-4)
                np.testing.assert_allclose(got[b, :n].numpy(),
                                           np.asarray(jwant)[b, :n],
                                           rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def reference_streams(params):
    """The reference SPEngine's greedy, sampled and ragged streams at
    sp=2 (one compile: the three calls share their shapes)."""
    jp, _ = params
    eng = JSP(jp, JP["tiny"], js.make_inference_mesh(tp=1, sp=2),
              min_prompt=8)
    batch = [prompt(40), prompt(33, 3)]
    out = []
    for kw in ({}, dict(temperature=0.8, top_p=0.9, seed=7),
               dict(temperature=0.7, top_k=20, seed=3)):
        r = eng.generate(batch, max_new_tokens=8, **kw)
        out.append((r.tokens.tolist(), r.lengths.tolist()))
    return batch, out


@pytest.mark.parametrize("tp", [1, 2])
def test_sp_engine_streams_equal_the_reference(params, reference_streams,
                                               tp):
    _, tparams = params
    batch, want = reference_streams
    m = mesh(tp=tp)
    sp = SPEngine(tparams if tp == 1 else ts.shard_params(tparams, m, TINY),
                  TINY, m, min_prompt=8)
    got = []
    for kw in ({}, dict(temperature=0.8, top_p=0.9, seed=7),
               dict(temperature=0.7, top_k=20, seed=3)):
        r = sp.generate(batch, max_new_tokens=8, **kw)
        got.append((r.tokens.tolist(), r.lengths.tolist()))
    assert got == want
    # and the single-device engine, greedy
    eng = Engine(tparams, TINY, device="cpu").generate(batch, 8)
    assert got[0] == (eng.tokens.tolist(), eng.lengths.tolist())


@pytest.mark.parametrize("tp", [1, 2])
def test_sp_engine_tied_heads_equal_the_engine(tied, tp):
    cfg, p = tied
    m = mesh(tp=tp)
    sp = SPEngine(p if tp == 1 else ts.shard_params(p, m, cfg), cfg, m,
                  min_prompt=8)
    batch = [prompt(40, 9), prompt(17, 4)]
    for kw in ({}, dict(temperature=0.8, top_p=0.9, seed=7)):
        a = sp.generate(batch, max_new_tokens=6, **kw)
        b = Engine(p, cfg, device="cpu").generate(batch, 6, **kw)
        assert a.tokens.tolist() == b.tokens.tolist()
        assert a.lengths.tolist() == b.lengths.tolist()


def test_fits_and_doors(params):
    _, tparams = params
    sp = SPEngine(tparams, TINY, mesh(), max_cache_len=256, min_prompt=64)
    assert not sp.fits(32, 8)  # below min_prompt
    assert sp.fits(64, 8)
    assert not sp.fits(250, 16)  # beyond the context
    with pytest.raises(ValueError, match="sp axis >= 2"):
        SPEngine(tparams, TINY, mesh(tp=2, sp=1))
    with pytest.raises(ValueError, match="prompt bucket 17 must divide"):
        sp_prefill(tparams, torch.zeros((1, 17), dtype=torch.long),
                   torch.tensor([17]), TINY, mesh())
    odd = dataclasses.replace(TINY, num_key_value_heads=1)
    with pytest.raises(ValueError, match="tp=2 must divide attention heads"):
        sp_prefill(tparams, torch.zeros((1, 16), dtype=torch.long),
                   torch.tensor([16]), odd, mesh(tp=2))
    # sp=3 widens the 64 bucket to 66 (the blocks must be equal)
    three = SPEngine(tparams, TINY, mesh(sp=3), min_prompt=8)
    p = prompt(40, 2)
    assert three.generate([p], 4).tokens.tolist() == \
        Engine(tparams, TINY, device="cpu").generate([p], 4).tokens.tolist()
    if not torch.cuda.is_available():
        # no fallback: the card's mesh needs cards
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            ts.make_inference_mesh(tp=1, sp=2, dp=1)


def server(tparams, sp_min=32, speculative=False):
    eng = Engine(tparams, TINY, device="cpu")
    spec = (SpeculativeEngine(tparams, TINY, tparams, TINY, k=2,
                              device="cpu") if speculative else None)
    return InferenceServer(eng, model_id="tiny", port=0, device="cpu",
                           sp=SPEngine(tparams, TINY, mesh(),
                                       min_prompt=sp_min),
                           speculative=spec)


def test_server_routes_long_prompts_sp(params):
    _, tparams = params
    srv = server(tparams)
    try:
        ids = prompt(48)
        resp = srv.complete({"prompt": ids, "max_tokens": 6})
        direct = srv.engine.generate([ids], max_new_tokens=6)
        assert resp["kubeinfer"]["route"] == "sp"
        assert resp["choices"][0]["tokens"] == \
            direct.tokens[0, : direct.lengths[0]].tolist()
        m = srv.registry.render().replace("'", '"')
        assert 'route="sp",outcome="ok"' in m
        short = srv.complete({"prompt": prompt(10), "max_tokens": 4})
        assert short["kubeinfer"]["route"] == "engine"
    finally:
        srv.stop()


def test_sp_outranks_speculative_for_long_prompts(params):
    _, tparams = params
    srv = server(tparams, speculative=True)
    try:
        srv.complete({"prompt": prompt(48), "max_tokens": 2})
        m = srv.registry.render().replace("'", '"')
        assert 'route="sp",outcome="ok"' in m
        srv.complete({"prompt": prompt(8), "max_tokens": 2})
        m = srv.registry.render().replace("'", '"')
        assert 'route="speculative",outcome="ok"' in m
    finally:
        srv.stop()


def test_build_server_takes_the_sp_flags(params):
    """``--sequence-parallel-size 2 --tensor-parallel-size 2`` on CPU
    ranks: one (tp, sp) mesh, the params sharded on it, a long prompt on
    route "sp" equal to the per-request engine's stream."""
    srv, cont = tsrv.build_server(
        ["--model", "tiny", "--random-init", "--port", "0",
         "--tensor-parallel-size", "2", "--sequence-parallel-size", "2",
         "--sp-min-prompt", "32", "--batch-slots", "0"], device="cpu")
    try:
        assert cont is None and srv.sp.mesh.shape == {"dp": 1, "tp": 2,
                                                      "sp": 2}
        assert isinstance(srv.sp.params, ts.ShardedParams)
        ids = prompt(40, 5)
        resp = srv.complete({"prompt": ids, "max_tokens": 5})
        want = srv.engine.generate([ids], 5)
        assert resp["kubeinfer"]["route"] == "sp"
        assert resp["choices"][0]["tokens"] == want.tokens[0].tolist()
    finally:
        srv.stop()
    with pytest.raises(ValueError, match="the mesh is"):
        tsrv.build_server(["--model", "tiny", "--random-init",
                           "--sequence-parallel-size", "2"], device="cpu",
                          mesh=mesh(tp=2, sp=1))
