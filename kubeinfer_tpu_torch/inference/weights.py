"""Parameter loading for the port's inference runtime.

Counterpart of ``kubeinfer_tpu/inference/weights.py`` for bf16/f32
weights: ``params_from_state_dict`` maps a llama-family HF state dict
onto ``model.py``'s tree (torch Linear ``[out, in]`` weights transposed
once to ``[in, out]``), and ``params_from_reference`` carries over the
JAX package's own parameter tree, given as numpy arrays. The int8 weight
path and ``load_pretrained`` (safetensors) wait: ROADMAP Queue 1, int8
weights and ``checkpoint.py`` / ``load_pretrained``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import Params

_WQ = "ROADMAP Queue 1, int8 weights (#15, weight_quant.py)"
_MOE = "ROADMAP Queue 1, slice 6: moe.py"


def _to_tensor(a, device, dtype) -> torch.Tensor:
    """numpy / torch leaf -> tensor on ``device`` in ``dtype``. A numpy
    dtype torch cannot take (bfloat16) goes through float32, exactly."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype)
    a = np.asarray(a)
    if a.dtype.kind != "f" or a.dtype.itemsize not in (4, 8):
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def params_from_state_dict(
    sd: Mapping[str, object], cfg: ModelConfig, dtype=torch.bfloat16,
    weight_dtype: str = "bf16", device=None,
) -> Params:
    """HF llama state dict (name -> tensor or array) -> the port's tree."""
    if weight_dtype == "int8":
        raise NotImplementedError(f"weight_dtype='int8': {_WQ}")
    if weight_dtype != "bf16":
        raise ValueError(f"weight_dtype must be bf16|int8: {weight_dtype!r}")
    if cfg.num_local_experts > 0:
        raise NotImplementedError(f"mixture-of-experts layers: {_MOE}")
    dev = resolve_device(device)

    def get(name: str):
        for key in (name, f"model.{name}"):
            if key in sd:
                return sd[key]
        raise KeyError(f"checkpoint missing tensor {name!r}")

    def vec(name: str) -> torch.Tensor:
        return _to_tensor(get(name), dev, dtype)

    def linear(name: str) -> torch.Tensor:
        w = get(name)
        w = w.T if isinstance(w, torch.Tensor) else np.asarray(w).T
        return _to_tensor(w, dev, dtype).contiguous()  # [out,in]->[in,out]

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        layer = {
            "input_layernorm": vec(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": vec(
                f"{p}.post_attention_layernorm.weight"),
            "q_proj": linear(f"{p}.self_attn.q_proj.weight"),
            "k_proj": linear(f"{p}.self_attn.k_proj.weight"),
            "v_proj": linear(f"{p}.self_attn.v_proj.weight"),
            "o_proj": linear(f"{p}.self_attn.o_proj.weight"),
            "gate_proj": linear(f"{p}.mlp.gate_proj.weight"),
            "up_proj": linear(f"{p}.mlp.up_proj.weight"),
            "down_proj": linear(f"{p}.mlp.down_proj.weight"),
        }
        if cfg.qkv_bias:  # Qwen2 family
            layer["q_bias"] = vec(f"{p}.self_attn.q_proj.bias")
            layer["k_bias"] = vec(f"{p}.self_attn.k_proj.bias")
            layer["v_bias"] = vec(f"{p}.self_attn.v_proj.bias")
        layers.append(layer)
    params: Params = {
        "embed_tokens": vec("embed_tokens.weight"),
        "layers": layers,
        "norm": vec("norm.weight"),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = linear("lm_head.weight")
    return params


def params_from_reference(tree, device=None, dtype=torch.float32) -> Params:
    """The JAX package's parameter tree with numpy leaves (the caller
    maps ``np.asarray`` over it) -> the port's tree: the same names and
    layout, every leaf a tensor on ``device`` in ``dtype``."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            if "qw" in node:
                raise NotImplementedError(
                    f"int8 weight leaf at {path}: {_WQ}")
            if path.endswith("moe"):
                raise NotImplementedError(f"mixture-of-experts layers: {_MOE}")
            return {k: conv(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}.{i}") for i, v in enumerate(node)]
        return _to_tensor(node, dev, dtype)

    return conv(tree, "params")
