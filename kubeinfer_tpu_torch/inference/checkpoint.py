"""Checkpoint/resume for the port's model.

Counterpart of ``kubeinfer_tpu/inference/checkpoint.py``, whose format
is orbax's (a JAX library). The port keeps its own: a directory holding

- ``params.safetensors``: every leaf under its flattened name
  (``embed_tokens``, ``layers.3.q_proj``, ``lm_head``; an int8 leaf as
  ``layers.3.q_proj.qw`` and ``layers.3.q_proj.scale``), written by
  ``weights.write_safetensors`` and read back by its reader;
- ``meta.json``: the reference's keys and values (``step``, ``config``,
  ``param_dtype`` spelled ``"bfloat16"``/``"float32"``, ``tied``,
  ``weight_dtype``).

A save is written into a temporary sibling directory and renamed into
place when complete, so a path that exists holds a whole checkpoint.
Restore is lossless: leaves come back in the dtypes they were saved in,
int8 codes and f32 scales included (never re-quantized). With ``mesh``
the leaves go straight from the mapped file to the tp ranks per
``sharding.param_specs``: each rank gets its own shard of every sharded
leaf (``sharding.ShardedParams``), and the whole tree never lands on a
device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import Params
from kubeinfer_tpu_torch.inference.sharding import shard_params
from kubeinfer_tpu_torch.inference.weight_quant import params_weight_dtype
from kubeinfer_tpu_torch.inference.weights import (
    read_safetensors,
    write_safetensors,
)

def _flatten(node, prefix: str, out: dict) -> dict:
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _flatten(v, f"{prefix}.{i}", out)
    else:
        out[prefix] = node
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for name, leaf in flat.items():
        *parents, last = name.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def save_checkpoint(
    path: str, params: Params, cfg: ModelConfig, step: int = 0
) -> None:
    """Write params + config + step to ``path`` (atomic on completion).
    An existing ``path`` is refused, as orbax's save refuses one."""
    root = pathlib.Path(path).absolute()
    if root.exists():
        raise FileExistsError(f"checkpoint path {root} already exists")
    root.parent.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix=f".{root.name}.",
                                        dir=root.parent))
    try:
        write_safetensors(tmp / "params.safetensors",
                          _flatten(params, "", {}))
        (tmp / "meta.json").write_text(json.dumps({
            "step": step,
            "config": dataclasses.asdict(cfg),
            # the reference's spelling (a jnp dtype's str), not torch's
            "param_dtype": str(params["norm"].dtype).removeprefix("torch."),
            "tied": "lm_head" not in params,
            # recorded so a restore never re-quantizes int8 codes
            "weight_dtype": params_weight_dtype(params),
        }))
        os.replace(tmp, root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def restore_checkpoint(
    path: str, mesh=None, device=None,
) -> tuple[Params, ModelConfig, int]:
    """Restore (params, config, step) onto ``device`` (the card by
    default), or with ``mesh`` (a ``sharding.Mesh``) onto its tp ranks,
    each rank reading its own shard of every leaf; then ``device`` is
    not used."""
    root = pathlib.Path(path).absolute()
    if not (root / "meta.json").exists():
        raise FileNotFoundError(f"no checkpoint at {root} (meta.json)")
    meta = json.loads((root / "meta.json").read_text())
    cfg = ModelConfig(**meta["config"])
    mapped = read_safetensors(root / "params.safetensors")
    if mesh is not None:
        # mapped host views: shard_params copies each rank's piece to its
        # device
        params = _unflatten(dict(mapped))
    else:
        dev = resolve_device(device)
        params = _unflatten({name: t.to(dev, copy=True)
                             for name, t in mapped.items()})
    if meta.get("weight_dtype", "bf16") != params_weight_dtype(params):
        raise ValueError(f"{root}: meta.json says weight_dtype "
                         f"{meta.get('weight_dtype')!r}, the tensors "
                         f"{params_weight_dtype(params)!r}")
    if mesh is not None:
        params = shard_params(params, mesh, cfg)
    return params, cfg, int(meta["step"])
