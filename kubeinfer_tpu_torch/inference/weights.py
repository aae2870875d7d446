"""Parameter loading for the port's inference runtime.

Counterpart of ``kubeinfer_tpu/inference/weights.py``:
``params_from_state_dict`` maps a llama-family HF state dict onto
``model.py``'s tree (torch Linear ``[out, in]`` weights transposed once
to ``[in, out]``; with ``weight_dtype="int8"`` each attention and dense
MLP projection is quantized as it is mapped; Mixtral's router and
experts, ``block_sparse_moe.gate`` and ``experts.{e}.w1/w3/w2``, stack
into the ``moe`` subtree in the load dtype), and
``params_from_reference`` carries over the JAX package's own parameter
tree, given as numpy arrays, int8 leaves included. ``load_pretrained`` reads an HF snapshot directory
(``config.json`` + ``*.safetensors``, what the coordinator's
``huggingface-cli download`` drops into the model cache) with the
module's own safetensors reader: each tensor is an ``np.memmap`` of its
byte range, opened only when the mapping reaches it, so host memory
holds about one tensor at a time. ``write_safetensors`` is the matching
writer (``checkpoint.py`` saves through it).
"""

from __future__ import annotations

import json
import os
import pathlib
from typing import Iterator, Mapping

import numpy as np
import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import Params
from kubeinfer_tpu_torch.inference.weight_quant import quantize_weight


def _to_tensor(a, device, dtype) -> torch.Tensor:
    """numpy / torch leaf -> tensor on ``device`` in ``dtype``. A numpy
    dtype torch cannot take (bfloat16) goes through float32, exactly."""
    if isinstance(a, torch.Tensor):
        # a copy always: a leaf never aliases its source (a memory-mapped
        # checkpoint file, a caller's tensor)
        return a.detach().to(device=device, dtype=dtype, copy=True)
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
        if isinstance(w, torch.Tensor):
            # the [out, in] bytes cross to the device as they lie and are
            # transposed there: a strided host copy of every projection
            # would cost as much as the load itself
            w = w.detach().to(dev).T
            if quant and weight_dtype == "int8":
                return quantize_weight(w.float())
            return w.to(dtype).contiguous()  # [out,in]->[in,out]
        w = np.asarray(w).T
        if quant and weight_dtype == "int8":
            return quantize_weight(_to_tensor(w, dev, torch.float32))
        return _to_tensor(w, dev, dtype).contiguous()

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
        }
        if cfg.num_local_experts > 0:
            # Mixtral naming: block_sparse_moe.gate is the router,
            # experts.{e}.w1/w3/w2 are gate/up/down, stacked on a leading
            # E axis (moe.py's layout); the experts stay in the load dtype
            m = f"{p}.block_sparse_moe"
            E = range(cfg.num_local_experts)
            layer["moe"] = {
                "router": linear(f"{m}.gate.weight"),
                "gate_proj": torch.stack(
                    [linear(f"{m}.experts.{e}.w1.weight") for e in E]),
                "up_proj": torch.stack(
                    [linear(f"{m}.experts.{e}.w3.weight") for e in E]),
                "down_proj": torch.stack(
                    [linear(f"{m}.experts.{e}.w2.weight") for e in E]),
            }
        else:
            layer["gate_proj"] = linear(f"{p}.mlp.gate_proj.weight", True)
            layer["up_proj"] = linear(f"{p}.mlp.up_proj.weight", True)
            layer["down_proj"] = linear(f"{p}.mlp.down_proj.weight", True)
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
            return {k: conv(v, f"{path}.{k}") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, f"{path}.{i}") for i, v in enumerate(node)]
        return _to_tensor(node, dev, dtype)

    return conv(tree, "params")


# safetensors dtype -> (numpy dtype of the stored bytes, torch dtype they
# are viewed as); BF16 and the F8 types have no numpy dtype, so their
# bytes are read as integers of the same width
_ST_DTYPES = {
    "BOOL": (np.dtype("bool"), torch.bool),
    "U8": (np.dtype("u1"), torch.uint8),
    "I8": (np.dtype("i1"), torch.int8),
    "I16": (np.dtype("<i2"), torch.int16),
    "U16": (np.dtype("<u2"), torch.uint16),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I32": (np.dtype("<i4"), torch.int32),
    "U32": (np.dtype("<u4"), torch.uint32),
    "F32": (np.dtype("<f4"), torch.float32),
    "I64": (np.dtype("<i8"), torch.int64),
    "U64": (np.dtype("<u8"), torch.uint64),
    "F64": (np.dtype("<f8"), torch.float64),
    "F8_E4M3": (np.dtype("u1"), torch.float8_e4m3fn),
    "F8_E5M2": (np.dtype("u1"), torch.float8_e5m2),
}
_ST_NAMES = {t: name for name, (_, t) in _ST_DTYPES.items()}


def safetensors_index(path) -> dict[str, tuple]:
    """Parse one ``.safetensors`` file's header: an 8-byte little-endian
    header length, a JSON header ``{name: {dtype, shape, data_offsets}}``
    (``__metadata__`` optional, skipped), then the raw buffers. Returns
    ``{name: (dtype, shape, absolute byte offset)}``; raises
    ``ValueError`` on an unknown dtype, a byte count that does not match
    the shape, or a range past the end of the file."""
    path = pathlib.Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: shorter than a safetensors header")
        n = int.from_bytes(head, "little")
        if 8 + n > size:
            raise ValueError(f"{path}: header of {n} bytes runs past the "
                             f"end of the file ({size} bytes)")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    base = 8 + n
    index = {}
    for name, e in header.items():
        dt = e.get("dtype")
        if dt not in _ST_DTYPES:
            raise ValueError(f"{path}: {name}: unknown dtype {dt!r}")
        shape = tuple(int(x) for x in e["shape"])
        lo, hi = (int(x) for x in e["data_offsets"])
        want = int(np.prod(shape, dtype=np.int64)) * _ST_DTYPES[dt][0].itemsize
        if lo < 0 or hi - lo != want:
            raise ValueError(f"{path}: {name}: {hi - lo} bytes for shape "
                             f"{list(shape)} {dt} ({want} expected)")
        if base + hi > size:
            raise ValueError(f"{path}: {name}: bytes [{lo}, {hi}) run past "
                             f"the end of the file")
        index[name] = (dt, shape, base + lo)
    return index


def map_tensor(path, dt: str, shape: tuple, offset: int) -> torch.Tensor:
    """One tensor of a safetensors file as a CPU tensor over an
    ``np.memmap`` of its bytes (copy-on-write: writes never reach the
    file); pages are read as they are touched."""
    np_dt, t_dt = _ST_DTYPES[dt]
    n = int(np.prod(shape, dtype=np.int64))
    if n == 0:
        arr = np.empty(shape, np_dt)
    else:
        arr = np.memmap(path, dtype=np_dt, mode="c", offset=offset,
                        shape=(n,)).reshape(shape)
    t = torch.from_numpy(arr)
    return t if t.dtype == t_dt else t.view(t_dt)


def read_safetensors(path) -> dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file (memory-mapped)."""
    return {name: map_tensor(path, *e)
            for name, e in safetensors_index(path).items()}


class _MappedShards(Mapping):
    """name -> tensor over a snapshot's shards, each tensor mapped only
    when it is asked for; a later shard's tensor replaces an earlier
    one of the same name, as a dict filled in shard order would."""

    def __init__(self, shards) -> None:
        self._where: dict[str, tuple] = {}
        for shard in shards:
            for name, e in safetensors_index(shard).items():
                self._where[name] = (shard, *e)

    def __getitem__(self, name: str) -> torch.Tensor:
        return map_tensor(*self._where[name])

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def write_safetensors(path, tensors: Mapping[str, torch.Tensor]) -> None:
    """Write ``tensors`` (any device) as one ``.safetensors`` file the
    reader above and the ``safetensors`` package both read: the header
    first (padded with spaces to 8 bytes), then each buffer in order,
    copied to the host one tensor at a time."""
    header: dict = {}
    off = 0
    for name, t in tensors.items():
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: no safetensors dtype for {t.dtype}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + nbytes]}
        off += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            h = t.detach().to("cpu").contiguous().view(-1)
            if h.numel():
                # numpy has no bf16 or f8: hand it their bits as integers
                f.write(h.view(_BITS.get(h.dtype, h.dtype)).numpy().data)
        f.flush()
        os.fsync(f.fileno())


_BITS = {torch.bfloat16: torch.int16, torch.float8_e4m3fn: torch.uint8,
         torch.float8_e5m2: torch.uint8}


def load_pretrained(
    model_dir: str, dtype=torch.bfloat16, weight_dtype: str = "bf16",
    device=None,
) -> tuple[Params, ModelConfig]:
    """Load (params, config) from an HF snapshot directory: ``config.json``
    through ``ModelConfig.from_hf_dict``, every ``*.safetensors`` shard in
    sorted order through ``params_from_state_dict`` (each projection
    moved to ``device`` as stored and transposed there; with
    ``weight_dtype="int8"`` quantized there)."""
    root = pathlib.Path(model_dir)
    with open(root / "config.json", "r", encoding="utf-8") as f:
        cfg = ModelConfig.from_hf_dict(json.load(f))
    shards = sorted(root.glob("*.safetensors"))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {model_dir}")
    sd = _MappedShards(shards)
    return params_from_state_dict(sd, cfg, dtype, weight_dtype,
                                  device), cfg
