"""The load path and the probe on the card (``cuda``-marked; they skip
without one). No JAX here: a checkpoint written by the port's own
writer from the port's ``init_params`` loads onto the card bitwise as it
loads on the CPU, bf16 and int8; the probe reads the card as
``torch.cuda`` does."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.model import init_params


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def write_checkpoint(root, cfg):
    """config.json + one bf16 shard of ``init_params(cfg, seed=0)``
    under HF names (projections ``[out, in]``, qwen2 biases)."""
    p = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    sd = {"model.embed_tokens.weight": p["embed_tokens"],
          "model.norm.weight": p["norm"], "lm_head.weight": p["lm_head"].T}
    for i, layer in enumerate(p["layers"]):
        for name, leaf in layer.items():
            if name.endswith("_bias"):
                key = f"self_attn.{name[0]}_proj.bias"
            elif name.endswith("layernorm"):
                key = f"{name}.weight"
            else:
                part = "mlp" if name in ("gate_proj", "up_proj",
                                         "down_proj") else "self_attn"
                key, leaf = f"{part}.{name}.weight", leaf.T
            sd[f"model.layers.{i}.{key}"] = leaf.contiguous()
    root.mkdir()
    (root / "config.json").write_text(json.dumps({
        "model_type": "qwen2", "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_hidden_layers,
        "num_attention_heads": cfg.num_attention_heads,
        "num_key_value_heads": cfg.num_key_value_heads,
        "max_position_embeddings": cfg.max_position_embeddings}))
    tw.write_safetensors(root / "model.safetensors", sd)


@pytest.mark.cuda
@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_load_pretrained_on_the_card_equals_the_cpu_load(tmp_path,
                                                         weight_dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = dataclasses.replace(PRESETS["tiny"], qkv_bias=True)
    write_checkpoint(tmp_path / "m", cfg)
    got, gcfg = tw.load_pretrained(str(tmp_path / "m"),
                                   weight_dtype=weight_dtype, device="cuda")
    want, _ = tw.load_pretrained(str(tmp_path / "m"),
                                 weight_dtype=weight_dtype, device="cpu")
    assert gcfg == cfg
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for name, t in w.items():
        assert g[name].device.type == "cuda", name
        assert g[name].dtype == t.dtype and torch.equal(g[name].cpu(), t), \
            name


@pytest.mark.cuda
def test_probe_reads_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from kubeinfer_tpu_torch.agent.probe import probe_accelerators

    info = probe_accelerators()
    total = sum(torch.cuda.mem_get_info(i)[1]
                for i in range(torch.cuda.device_count()))
    assert info.count == torch.cuda.device_count() >= 1
    assert info.platform == "gpu" and info.memory_free_known
    assert info.memory_bytes == total
    assert 0 < info.memory_free_bytes <= info.memory_bytes
