"""The port's model against the JAX package's: ``params_from_reference``
on the reference's ``init_params`` trees, then ``forward`` logits within
1e-5 (f32) with no cache, a dense scalar-offset cache, per-row offsets
(T == 1 and T > 1) and the paged write; ``params_from_state_dict``
against the reference's on one HF-named numpy dict."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import config as jc
from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu.inference import model as jm
from kubeinfer_tpu.inference import weights as jw
from kubeinfer_tpu_torch.inference import config as tc
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import weights as tw

TOL = 1e-5
SMALL = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=512)
CONFIGS = {
    "tiny": None,
    "tiny-gemma": None,
    "qwen2": dict(SMALL, qkv_bias=True, rope_theta=1e6, rms_norm_eps=1e-6),
    "head_dim_override": dict(SMALL, hidden_size=48, head_dim_override=32),
}


def configs(name):
    kw = CONFIGS[name]
    if kw is None:
        return jc.PRESETS[name], tc.PRESETS[name]
    return jc.ModelConfig(**kw), tc.ModelConfig(**kw)


def both_params(name, seed=0):
    jcfg, tcfg = configs(name)
    p = jm.init_params(jcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    # non-trivial norms and biases (the reference inits them to 1/0)
    for layer in tree["layers"]:
        for key in list(layer):
            if key.endswith("layernorm") or key.endswith("_bias"):
                layer[key] = (1.0 + 0.1 * rng.standard_normal(
                    layer[key].shape)).astype(np.float32)
    p = jax.tree.map(jnp.asarray, tree)
    return jcfg, tcfg, p, tw.params_from_reference(tree, "cpu")


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_reference(name):
    jcfg, tcfg, jp, tp = both_params(name)
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    want = jm.forward(jp, jnp.asarray(toks), jcfg)[0]
    got = tm.forward(tp, torch.from_numpy(toks).long(), tcfg)[0]
    close(got.numpy(), want)
    hid = tm.forward(tp, torch.from_numpy(toks).long(), tcfg,
                     return_hidden=True)[0]
    close(hid.numpy(), jm.forward(jp, jnp.asarray(toks), jcfg,
                                  return_hidden=True)[0])


@pytest.mark.parametrize("name", ["tiny", "qwen2", "head_dim_override"])
def test_dense_cache_scalar_and_per_row_offsets(name):
    """A chunk at a scalar offset (the chunked prefill's write), then one
    decode token per row at per-row offsets, then a two-token per-row
    write (the reference's vmapped dynamic_update_slice)."""
    jcfg, tcfg, jp, tp = both_params(name, 2)
    B, S, C = 2, 32, 8
    nkv, D = jcfg.num_key_value_heads, jcfg.head_dim
    jcache = [(jnp.zeros((B, S, nkv, D)), jnp.zeros((B, S, nkv, D)))
              for _ in range(jcfg.num_hidden_layers)]
    tcache = [(torch.zeros(B, S, nkv, D), torch.zeros(B, S, nkv, D))
              for _ in range(tcfg.num_hidden_layers)]
    rng = np.random.default_rng(3)
    pos = np.arange(S)
    for c0 in (0, 8):
        toks = rng.integers(0, 256, (B, C)).astype(np.int32)
        mask = (pos[None, None, :] <= (c0 + np.arange(C))[None, :, None]) & \
            np.ones((B, 1, 1), bool)
        want, jcache = jm.forward(jp, jnp.asarray(toks), jcfg,
                                  attn_mask=jnp.asarray(mask),
                                  kv_caches=jcache, cache_offset=c0)
        got, tcache = tm.forward(tp, torch.from_numpy(toks).long(), tcfg,
                                 attn_mask=torch.from_numpy(mask),
                                 kv_caches=tcache, cache_offset=c0)
        close(got.numpy(), want)
    for T, off in ((1, np.array([16, 18])), (2, np.array([17, 30]))):
        toks = rng.integers(0, 256, (B, T)).astype(np.int32)
        q_pos = off[:, None] + np.arange(T)
        mask = pos[None, None, :] <= q_pos[:, :, None]
        want, jcache = jm.forward(jp, jnp.asarray(toks), jcfg,
                                  attn_mask=jnp.asarray(mask),
                                  kv_caches=jcache,
                                  cache_offset=jnp.asarray(off, jnp.int32))
        got, tcache = tm.forward(tp, torch.from_numpy(toks).long(), tcfg,
                                 attn_mask=torch.from_numpy(mask),
                                 kv_caches=tcache,
                                 cache_offset=torch.from_numpy(off))
        close(got.numpy(), want)
    for (jk, jv), (tk, tv) in zip(jcache, tcache):
        close(tk.numpy(), jk)
        close(tv.numpy(), jv)


@pytest.mark.parametrize("name", ["tiny", "tiny-gemma"])
def test_paged_write_and_read(name):
    """One decode token per row into a shared pool through block tables
    (a retired row with an all-null table writes into block 0)."""
    jcfg, tcfg, jp, tp = both_params(name, 4)
    nkv, D, L = jcfg.num_key_value_heads, jcfg.head_dim, \
        jcfg.num_hidden_layers
    NB, bs, M = 10, 8, 4
    rng = np.random.default_rng(5)
    pools = [(rng.standard_normal((NB, bs, nkv, D)).astype(np.float32),
              rng.standard_normal((NB, bs, nkv, D)).astype(np.float32))
             for _ in range(L)]
    tbl = np.array([[3, 4, 0, 0], [3, 7, 8, 0], [0, 0, 0, 0]], np.int32)
    off = np.array([11, 20, 5], np.int32)
    toks = rng.integers(0, 256, (3, 1)).astype(np.int32)
    mask = np.arange(M * bs)[None, None, :] < (off + 1)[:, None, None]

    def j_attn(q, k, v, m):
        return jfa.decode_attention_blocks_auto(q, k, v, jnp.asarray(tbl),
                                                jnp.asarray(off + 1), m)

    def t_attn(q, k, v, m):
        return tfa.decode_attention_blocks_auto(q, k, v, torch.from_numpy(tbl),
                                                torch.from_numpy(off + 1), m)

    want, jpools = jm.forward(
        jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(off[:, None]),
        attn_mask=jnp.asarray(mask),
        kv_caches=[(jnp.asarray(k), jnp.asarray(v)) for k, v in pools],
        cache_offset=jnp.asarray(off), block_tables=jnp.asarray(tbl),
        attn_fn=j_attn)
    tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
              for k, v in pools]
    got, tpools = tm.forward(
        tp, torch.from_numpy(toks).long(), tcfg,
        positions=torch.from_numpy(off[:, None]).long(),
        attn_mask=torch.from_numpy(mask),
        kv_caches=tpools, cache_offset=torch.from_numpy(off).long(),
        block_tables=torch.from_numpy(tbl), attn_fn=t_attn)
    close(got[:2].numpy(), np.asarray(want)[:2])  # the live rows
    for (jk, jv), (tk, tv) in zip(jpools, tpools):
        # block 0 holds the retired row's junk write on both sides
        close(tk[1:].numpy(), np.asarray(jk)[1:])
        close(tv[1:].numpy(), np.asarray(jv)[1:])


@pytest.mark.parametrize("name", ["tiny", "qwen2"])
def test_quantized_forward_matches_reference(name):
    """The reference's ``quantize_params`` tree carried over as int8
    codes and f32 scales: the forward (every projection through the
    plain version of #15) and a dense-cache decode within 1e-5 (f32)."""
    from kubeinfer_tpu.inference import weight_quant as jq

    jcfg, tcfg, jp, _ = both_params(name, 8)
    jq_p = jq.quantize_params(jp)
    tq_p = tw.params_from_reference(jax.tree.map(np.asarray, jq_p), "cpu")
    assert tq_p["layers"][0]["q_proj"]["qw"].dtype == torch.int8
    toks = np.random.default_rng(9).integers(0, 256, (2, 7)).astype(np.int32)
    want = jm.forward(jq_p, jnp.asarray(toks), jcfg)[0]
    got = tm.forward(tq_p, torch.from_numpy(toks).long(), tcfg)[0]
    close(got.numpy(), want)


@pytest.mark.parametrize("name", ["tiny", "qwen2"])
def test_params_from_state_dict_matches_reference(name):
    jcfg, tcfg = configs(name)
    rng = np.random.default_rng(7)
    H, F, V = jcfg.hidden_size, jcfg.intermediate_size, jcfg.vocab_size
    q_dim = jcfg.num_attention_heads * jcfg.head_dim
    kv_dim = jcfg.num_key_value_heads * jcfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H),
          "lm_head.weight": w(V, H)}
    for i in range(jcfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": w(H),
            f"{p}.post_attention_layernorm.weight": w(H),
            f"{p}.self_attn.q_proj.weight": w(q_dim, H),
            f"{p}.self_attn.k_proj.weight": w(kv_dim, H),
            f"{p}.self_attn.v_proj.weight": w(kv_dim, H),
            f"{p}.self_attn.o_proj.weight": w(H, q_dim),
            f"{p}.mlp.gate_proj.weight": w(F, H),
            f"{p}.mlp.up_proj.weight": w(F, H),
            f"{p}.mlp.down_proj.weight": w(H, F),
        })
        if jcfg.qkv_bias:
            sd.update({f"{p}.self_attn.q_proj.bias": w(q_dim),
                       f"{p}.self_attn.k_proj.bias": w(kv_dim),
                       f"{p}.self_attn.v_proj.bias": w(kv_dim)})
    ref = jax.tree.map(np.asarray,
                       jw.params_from_state_dict(sd, jcfg, jnp.float32))
    got = tw.params_from_state_dict(sd, tcfg, torch.float32, device="cpu")
    flat_r, tree_r = jax.tree.flatten(ref)
    flat_g, tree_g = jax.tree.flatten(got, is_leaf=torch.is_tensor)
    assert tree_r == tree_g
    for a, b in zip(flat_g, flat_r):
        np.testing.assert_array_equal(a.numpy(), b)


def test_waiting_features_raise():
    """MoE layers and the manual tp names are ported: a MoE init has the
    reference's tree shapes (parity: ``tests/test_torch_moe.py``), and
    ``tp_axis`` raises only where its shards are missing or the sizes
    disagree; a bad weight dtype still raises."""
    kw = dict(SMALL, num_local_experts=2)
    moe = tm.init_params(tc.ModelConfig(**kw), device="cpu")
    ref = jm.init_params(jc.ModelConfig(**kw), jax.random.PRNGKey(0))
    assert [tuple(x.shape) for x in moe["layers"][0]["moe"].values()] == \
        [tuple(x.shape) for x in ref["layers"][0]["moe"].values()]
    with pytest.raises(ValueError, match="weight_dtype"):
        tw.params_from_state_dict({}, tc.PRESETS["tiny"],
                                  weight_dtype="fp8", device="cpu")
    from kubeinfer_tpu_torch.inference import sharding as ts

    tiny = tc.PRESETS["tiny"]
    plain = tm.init_params(tiny, device="cpu")
    toks = torch.zeros((1, 2), dtype=torch.long)
    with pytest.raises(ValueError, match="needs params sharded over tp=1"):
        tm.forward(plain, toks, tiny, tp_axis="tp")
    sharded = ts.shard_params(plain, ts.make_inference_mesh(
        tp=2, sp=1, dp=1, devices=["cpu"] * 2), tiny)
    with pytest.raises(ValueError, match="tp=4 .* got tp=2"):
        tm.forward(sharded, toks, tiny, tp_axis="tp", tp_size=4)
    with pytest.raises(ValueError, match="decoder_layer takes one plain"):
        tm.decoder_layer(plain["layers"][0], None, None, None, None, tiny,
                         tp_axis="tp", tp_size=2)
    got, _ = tm.forward(sharded, toks, tiny, tp_axis="tp", tp_size=2)
    assert torch.equal(got, tm.forward(sharded, toks, tiny)[0])
