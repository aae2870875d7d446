"""Parameter loading for the port's inference runtime.

Counterpart of ``kubeinfer_tpu/inference/weights.py``:
``params_from_state_dict`` maps a llama-family HF state dict onto
``model.py``'s tree (torch Linear ``[out, in]`` weights transposed once
to ``[in, out]``; with ``weight_dtype="int8"`` each projection is
quantized as it is mapped), and ``params_from_reference`` carries over
the JAX package's own parameter tree, given as numpy arrays, int8 leaves
included. ``load_pretrained`` (safetensors) waits: ROADMAP Queue 1,
``checkpoint.py`` / ``load_pretrained``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import Params
from kubeinfer_tpu_torch.inference.weight_quant import quantize_weight

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
    """HF llama state dict (name -> tensor or array) -> the port's tree.
    ``weight_dtype="int8"`` quantizes each projection from its f32 copy
    as it is mapped (the reference's order), so no full-precision
    projection reaches the device."""
    if weight_dtype not in ("bf16", "int8"):
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

    def linear(name: str, quant: bool = False):
        w = get(name)
        w = w.T if isinstance(w, torch.Tensor) else np.asarray(w).T
        if quant and weight_dtype == "int8":
            return quantize_weight(_to_tensor(w, dev, torch.float32))
        return _to_tensor(w, dev, dtype).contiguous()  # [out,in]->[in,out]

    layers = []
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}"
        layer = {
            "input_layernorm": vec(f"{p}.input_layernorm.weight"),
            "post_attention_layernorm": vec(
                f"{p}.post_attention_layernorm.weight"),
            "q_proj": linear(f"{p}.self_attn.q_proj.weight", True),
            "k_proj": linear(f"{p}.self_attn.k_proj.weight", True),
            "v_proj": linear(f"{p}.self_attn.v_proj.weight", True),
            "o_proj": linear(f"{p}.self_attn.o_proj.weight", True),
            "gate_proj": linear(f"{p}.mlp.gate_proj.weight", True),
            "up_proj": linear(f"{p}.mlp.up_proj.weight", True),
            "down_proj": linear(f"{p}.mlp.down_proj.weight", True),
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
    layout, every leaf a tensor on ``device`` in ``dtype``, except the
    int8 leaves ``{"qw", "scale"}``, which stay int8 codes and f32
    scales (a cast to ``dtype`` would turn them into a plain weight)."""
    dev = resolve_device(device)

    def conv(node, path):
        if isinstance(node, dict):
            if "qw" in node:
                return {"qw": torch.from_numpy(
                            np.asarray(node["qw"], np.int8).copy()).to(dev),
                        "scale": _to_tensor(node["scale"], dev,
                                            torch.float32)}
            if path.endswith("moe"):
                raise NotImplementedError(f"mixture-of-experts layers: {_MOE}")
            return {k: conv(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}.{i}") for i, v in enumerate(node)]
        return _to_tensor(node, dev, dtype)

    return conv(tree, "params")
