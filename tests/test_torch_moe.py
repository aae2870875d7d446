"""The port's mixture-of-experts path against the JAX package's, on the
CPU: ``inference/moe.py`` (the router, the dense block, the
expert-parallel block on ``ep`` ranks of repeated ``cpu`` devices), the
Mixtral layers of ``model.py`` (plain and tp-sharded), the Mixtral
checkpoint naming of ``load_pretrained``, the ``moe`` subtree through
``checkpoint.py``, and a MoE ``ContinuousEngine``. The reference's
parameters are carried across (``weights.params_from_reference``); the
reference runs on its 8 virtual CPU devices.

Tolerances (f32): the router weights and ``moe_block`` within 1e-5,
``moe_block_ep`` within 1e-5 (the ep sum reorders the experts' parts),
MoE logits within 2e-4 as the reference's own tests; token streams and
loaded trees equal.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from kubeinfer_tpu.inference import forward as j_forward
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import moe as jmoe
from kubeinfer_tpu.inference import sharding as js
from kubeinfer_tpu.inference import weights as jw
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu.inference.config import ModelConfig as JCfg
from kubeinfer_tpu_torch.inference import checkpoint as tck
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import moe as tmoe
from kubeinfer_tpu_torch.inference import sharding as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.config import ModelConfig as TCfg

MOE = dict(vocab_size=128, hidden_size=32, intermediate_size=48,
           num_hidden_layers=2, num_attention_heads=4,
           num_key_value_heads=2, max_position_embeddings=256,
           num_local_experts=4, num_experts_per_tok=2)
CPU = ["cpu"] * 8


def t(a):
    return torch.from_numpy(np.array(a))


def carried_moe(H=16, F=32, E=8, seed=6):
    jp = jmoe.init_moe_params(jax.random.PRNGKey(seed), H, F, E)
    return jp, tw.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = JCfg(**MOE)
    jp = j_init(jcfg, jax.random.PRNGKey(3))
    return jcfg, TCfg(**MOE), jp, tw.params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


def test_router_keeps_every_expert_tied_at_the_threshold():
    jp, tp = carried_moe()
    # small integers: every logit is exact, and expert 5 repeats expert
    # 2's column, so rows put a tie at the top-2 threshold
    rng = np.random.default_rng(7)
    router = rng.integers(-4, 5, (16, 8)).astype(np.float32)
    router[:, 5] = router[:, 2]
    x = rng.integers(-2, 3, (1, 64, 16)).astype(np.float32)
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=t(router))
    want = np.asarray(jmoe._router_weights(jp, jnp.asarray(x), top_k=2))
    got = tmoe._router_weights(tp, t(x), top_k=2).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    logits = x @ router
    kept = (logits >= np.sort(logits, -1)[..., -2:-1]).sum(-1)
    assert (kept > 2).any(), "no row puts a tie at the threshold"
    # every expert at or above the k-th largest keeps its weight
    np.testing.assert_array_equal((got > 0).sum(-1), kept)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_block_matches_reference(top_k):
    jp, tp = carried_moe(H=32, F=64, E=8, seed=4)
    x = np.random.default_rng(5).normal(size=(2, 6, 32)).astype(np.float32)
    want = np.asarray(jmoe.moe_block(jp, jnp.asarray(x), top_k=top_k))
    got = tmoe.moe_block(tp, t(x), top_k=top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("ep,top_k", [(2, 1), (2, 2), (4, 1), (4, 2)])
def test_moe_block_ep_matches_reference(ep, top_k):
    jp, tp = carried_moe(H=32, F=64, E=8, seed=8)
    x = np.random.default_rng(9).normal(size=(1, 4, 32)).astype(np.float32)
    want = np.asarray(jmoe.moe_block_ep(jp, jnp.asarray(x),
                                        jmoe.make_ep_mesh(ep), top_k=top_k))
    mesh = tmoe.make_ep_mesh(ep, CPU)
    got = tmoe.moe_block_ep(tp, t(x), mesh, top_k=top_k).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ranks = tmoe.shard_experts(tp, mesh)
    assert [r["gate_proj"].shape[0] for r in ranks] == [8 // ep] * ep
    with pytest.raises(ValueError, match="do not divide over ep=3"):
        tmoe.shard_experts(tp, tmoe.make_ep_mesh(3, CPU))


def test_init_and_template_follow_the_reference(model):
    jcfg, tcfg, jp, _ = model
    mine = tm.init_params(tcfg, seed=0, device="cpu")
    assert (jax.tree.structure(jax.tree.map(lambda _: 0, jp))
            == jax.tree.structure(jax.tree.map(
                lambda _: 0, mine, is_leaf=torch.is_tensor)))
    for a, b in zip(jax.tree.leaves(jp),
                    jax.tree.leaves(mine, is_leaf=torch.is_tensor)):
        assert tuple(a.shape) == tuple(b.shape)
    from kubeinfer_tpu.inference.model import layer_param_template as jt

    for kw in (MOE, dict(MOE, num_local_experts=0), dict(MOE, qkv_bias=True)):
        assert tm.layer_param_template(TCfg(**kw)) == jt(JCfg(**kw))
    assert "moe" in mine["layers"][0] and "gate_proj" not in mine["layers"][0]


@pytest.mark.parametrize("tp", [1, 2])
def test_moe_forward_matches_reference(model, tp):
    jcfg, tcfg, jp, tparams = model
    toks = np.random.default_rng(11).integers(0, 128, (2, 12)).astype(
        np.int32)
    if tp == 1:
        want, _ = j_forward(jp, jnp.asarray(toks), jcfg)
        got, _ = tm.forward(tparams, t(toks).long(), tcfg)
    else:
        want = js.forward_tensor_parallel(
            jp, jnp.asarray(toks), jcfg,
            js.make_inference_mesh(tp=2, sp=1, dp=1))
        mesh = ts.make_inference_mesh(tp=2, sp=1, dp=1, devices=CPU)
        sharded = ts.shard_params(tparams, mesh, tcfg)
        # every expert's F/tp lanes a rank, the router whole
        moe = sharded.shards[1]["layers"][0]["moe"]
        assert tuple(moe["gate_proj"].shape) == (4, 32, 24)
        assert tuple(moe["down_proj"].shape) == (4, 24, 32)
        assert tuple(moe["router"].shape) == (32, 4)
        got = ts.forward_tensor_parallel(sharded, t(toks).long(), tcfg, mesh)
        # the reference's manual-tp names run the same sharded layers
        manual, _ = tm.forward(sharded, t(toks).long(), tcfg, tp_axis="tp",
                               tp_size=2)
        assert torch.equal(manual, got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def streams(eng, prompt, n):
    """Cold greedy, sampled, then a warm (radix-hit) readmit."""
    try:
        return (eng.generate(prompt, n),
                eng.generate(prompt, n, temperature=0.8, seed=5, top_k=13),
                eng.generate(prompt, n))
    finally:
        eng.stop()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_moe_continuous_engine_matches_reference(model, kv):
    jcfg, tcfg, jp, tparams = model
    prompt = np.random.default_rng(12).integers(0, 128, 11).tolist()
    kw = dict(n_slots=2, cache_len=64, block_size=8, max_window=4,
              kv_dtype=kv, weight_dtype=kv)
    want = streams(JC(jp, jcfg, **kw).start(), prompt, 10)
    eng = TC(tparams, tcfg, device="cpu", **kw).start()
    layer = eng.params["layers"][0]
    # int8 weights quantize the attention projections; the experts stay
    # in the load dtype, as in the reference
    assert (isinstance(layer["q_proj"], dict)) == (kv == "int8")
    assert layer["moe"]["gate_proj"].dtype == torch.float32
    assert streams(eng, prompt, 10) == want


def mixtral_dir(root, jcfg, tree):
    """An HF Mixtral snapshot of the reference's tree: Mixtral names,
    [out, in] projections, experts one tensor each."""
    root.mkdir(parents=True, exist_ok=True)
    cfg = {**MOE, "model_type": "mixtral", "tie_word_embeddings": False,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0}
    (root / "config.json").write_text(json.dumps(cfg))
    sd = {"model.embed_tokens.weight": tree["embed_tokens"],
          "model.norm.weight": tree["norm"],
          "lm_head.weight": tree["lm_head"].T}
    for i, layer in enumerate(tree["layers"]):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = layer["input_layernorm"]
        sd[p + "post_attention_layernorm.weight"] = \
            layer["post_attention_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{n}.weight"] = layer[n].T
        m = p + "block_sparse_moe."
        sd[m + "gate.weight"] = layer["moe"]["router"].T
        for e in range(jcfg.num_local_experts):
            for w, n in (("w1", "gate_proj"), ("w3", "up_proj"),
                         ("w2", "down_proj")):
                sd[m + f"experts.{e}.{w}.weight"] = layer["moe"][n][e].T
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()},
              str(root / "model.safetensors"))
    return root


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_mixtral_checkpoint_loads_as_the_reference(model, tmp_path,
                                                   weight_dtype):
    jcfg, tcfg, jp, _ = model
    root = mixtral_dir(tmp_path / "mixtral", jcfg,
                       jax.tree.map(np.asarray, jp))
    want, wcfg = jw.load_pretrained(str(root), dtype=jnp.float32,
                                    weight_dtype=weight_dtype)
    got, gcfg = tw.load_pretrained(str(root), dtype=torch.float32,
                                   weight_dtype=weight_dtype, device="cpu")
    assert dataclasses.asdict(gcfg) == dataclasses.asdict(wcfg)
    flat_w = jax.tree.leaves_with_path(want)
    flat_g = jax.tree.leaves_with_path(got, is_leaf=torch.is_tensor)
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))
    assert isinstance(got["layers"][1]["moe"]["up_proj"], torch.Tensor)


def test_checkpoint_roundtrip_and_sharded_restore_with_moe(model, tmp_path):
    _, tcfg, _, tparams = model
    tck.save_checkpoint(str(tmp_path / "ck"), tparams, tcfg, step=7)
    got, rcfg, step = tck.restore_checkpoint(str(tmp_path / "ck"),
                                             device="cpu")
    assert step == 7 and rcfg == tcfg
    for (pg, g), (pw, w) in zip(
            jax.tree.leaves_with_path(got, is_leaf=torch.is_tensor),
            jax.tree.leaves_with_path(tparams, is_leaf=torch.is_tensor)):
        assert pg == pw and torch.equal(g, w)
    mesh = ts.make_inference_mesh(tp=2, sp=1, dp=1, devices=CPU)
    sharded, _, _ = tck.restore_checkpoint(str(tmp_path / "ck"), mesh=mesh)
    want = ts.shard_params(tparams, mesh, tcfg)
    for r in range(2):
        for name in ("router", "gate_proj", "up_proj", "down_proj"):
            assert torch.equal(sharded.shards[r]["layers"][1]["moe"][name],
                               want.shards[r]["layers"][1]["moe"][name])
