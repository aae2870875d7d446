"""The port's pipeline parallelism (``inference/pipeline.py``) against
the JAX package's, on the CPU: the reference's GPipe ``shard_map`` on its
8 virtual CPU devices, the port's stages on pp ranks of repeated ``cpu``
devices, with the reference's parameters carried across
(``weights.params_from_reference``). Families: llama (``tiny``), Qwen2's
q/k/v biases, Mixtral's MoE layers and Gemma's flags (scaled embeddings,
offset norms, tied head, GeGLU), at M = 2 and 4 microbatches.

Tolerance (f32): logits within 2e-4 of the reference's pipeline and of
the port's dense forward (``forward(attn_fn=attention)``), as the
reference's own tests.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import pipeline as jpl
from kubeinfer_tpu.inference.config import ModelConfig as JCfg
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import pipeline as tpl
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import ModelConfig as TCfg

CPU = ["cpu"] * 8
SMALL = dict(vocab_size=128, hidden_size=32, intermediate_size=64,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2)
FAMILIES = {
    "llama": dict(dataclasses.asdict(JP["tiny"])),
    "qwen2": dict(SMALL, qkv_bias=True),
    "mixtral": dict(SMALL, num_local_experts=4, num_experts_per_tok=2),
    "gemma": dict(SMALL, tie_word_embeddings=True, scale_embeddings=True,
                  rmsnorm_offset=True, hidden_act="gelu_pytorch_tanh"),
}


def carried(kw, seed=4):
    jcfg = JCfg(**kw)
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # nonzero biases and norm offsets, so a dropped one shows
    for layer in jp["layers"]:
        for name in ("q_bias", "k_bias", "v_bias", "input_layernorm"):
            if name in layer and (name != "input_layernorm"
                                  or kw.get("rmsnorm_offset")):
                layer[name] = jnp.asarray(0.1 * rng.standard_normal(
                    layer[name].shape).astype(np.float32))
    return jcfg, TCfg(**kw), jp, tw.params_from_reference(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("family,pp,M", [
    ("llama", 2, 2), ("llama", 2, 4), ("qwen2", 2, 2), ("mixtral", 4, 2),
    ("gemma", 2, 4)])
def test_pipeline_matches_reference_and_dense(family, pp, M):
    jcfg, tcfg, jp, tparams = carried(FAMILIES[family])
    toks = np.random.default_rng(6).integers(0, 128, (4, 8)).astype(
        np.int32)
    want = np.asarray(jpl.pipeline_forward(jp, jnp.asarray(toks), jcfg,
                                           jpl.make_pp_mesh(pp),
                                           n_microbatches=M))
    got = tpl.pipeline_forward(tparams, torch.from_numpy(toks).long(), tcfg,
                               tpl.make_pp_mesh(pp, CPU), n_microbatches=M)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    dense, _ = tm.forward(tparams, torch.from_numpy(toks).long(), tcfg,
                          attn_fn=tm.attention)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_stages_and_indivisible_doors():
    _, tcfg, _, tparams = carried(FAMILIES["mixtral"])
    mesh = tpl.make_pp_mesh(2, CPU)
    stacked = tpl.stack_stage_params(tparams, 2, mesh.axis_devices("pp"),
                                     tcfg)
    assert [len(s) for s in stacked["layers"]] == [2, 2]
    assert stacked["layers"][1][0] is not None
    with pytest.raises(ValueError, match="4 layers do not divide into 3"):
        tpl.stack_stage_params(tparams, 3)
    with pytest.raises(ValueError, match="must divide into 2 microbatches"):
        tpl.pipeline_forward(tparams, torch.zeros((3, 8), dtype=torch.long),
                             tcfg, mesh, n_microbatches=2)
    with pytest.raises(ValueError) as want:
        jpl.pipeline_forward(
            j_init(JP["tiny"], jax.random.PRNGKey(0)),
            jnp.zeros((3, 8), jnp.int32), JP["tiny"], jpl.make_pp_mesh(2),
            n_microbatches=2)
    assert str(want.value) == "batch 3 must divide into 2 microbatches"
    dense = TCfg(**SMALL)
    with pytest.raises(ValueError, match="are not the config's"):
        tpl.stack_stage_params(tparams, 2, cfg=dense)
    assert tpl.make_pp_mesh(4, CPU).shape == {"pp": 4}
    with pytest.raises(ValueError, match="pp=9 needs 9 devices, have 8"):
        tpl.make_pp_mesh(9, CPU)
