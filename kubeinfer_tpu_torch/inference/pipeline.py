"""Pipeline parallelism: decoder stages over a ``pp`` mesh axis.

Counterpart of ``kubeinfer_tpu/inference/pipeline.py``. The L layers
split into P contiguous stages, stage p's layers on pp rank p's device
(``stack_stage_params``); the batch splits into M microbatches. The
GPipe schedule runs ``M + P - 1`` ticks: in tick t stage 0 embeds
microbatch t (Gemma's embedding scale included), stage p runs its layers
on the microbatch that reached it (``t - p``) with the dense causal
``attention``, as ``decoder_layer`` runs in the reference's body, and
hands the activation to the next rank's device (``.to()``, the same
tensor where the device repeats; the reference's ``ppermute``). The last
stage records microbatch ``t - P + 1``. Stages carry ACTIVATIONS, not
logits: after the ticks the final norm and the head run once over the
whole batch, on the first rank's device.

One process drives every stage, so a tick's stages run one after the
other; a stage with no microbatch in a tick (the fill and drain bubble)
computes nothing, where the reference's stages compute on zeros and
throw the result away. The stages are plain PyTorch, cuBLAS products on
the card: the reference's pipeline body calls ``decoder_layer`` with the
dense einsum attention, outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import (
    Params,
    attention,
    causal_mask,
    decoder_layer,
    embed,
    layer_param_template,
    lm_logits,
    params_to,
    rms_norm,
    rope_tables,
)
from kubeinfer_tpu_torch.inference.sharding import Mesh, make_axis_mesh


def _same_keys(tree, template) -> bool:
    if isinstance(template, dict):
        return (isinstance(tree, dict) and tree.keys() == template.keys()
                and all(_same_keys(tree[k], v) for k, v in template.items()))
    return True


def stack_stage_params(params: Params, n_stages: int, devices=None,
                       cfg: ModelConfig | None = None) -> Params:
    """The tree with ``layers`` regrouped into ``n_stages`` lists of
    contiguous layers, stage p's on ``devices[p]`` (where they lie when
    ``devices`` is None). With ``cfg`` every layer must carry the keys of
    ``layer_param_template(cfg)``."""
    L = len(params["layers"])
    if L % n_stages:
        raise ValueError(f"{L} layers do not divide into {n_stages} stages")
    if cfg is not None:
        template = layer_param_template(cfg)
        for i, layer in enumerate(params["layers"]):
            if not _same_keys(layer, template):
                raise ValueError(f"layer {i}'s keys {sorted(layer)} are not "
                                 f"the config's {sorted(template)}")
    per = L // n_stages
    stages = []
    for s in range(n_stages):
        chunk = params["layers"][s * per:(s + 1) * per]
        stages.append(chunk if devices is None
                      else params_to(chunk, devices[s]))
    out = dict(params)
    out["layers"] = stages
    return out


def pipeline_forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                     mesh: Mesh, n_microbatches: int = 4) -> torch.Tensor:
    """Causal-LM logits [B, T, V] f32 with the layers pipelined over the
    mesh's ``pp`` ranks, on the first rank's device. B must divide by
    ``n_microbatches``. Equal to the dense forward
    (``forward(attn_fn=attention)``) up to rounding; only the schedule
    differs."""
    B, T = tokens.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    devs = mesh.axis_devices("pp")
    PP = len(devs)
    stages = stack_stage_params(params, PP, devs, cfg)["layers"]
    first = devs[0]
    home = params["embed_tokens"].device
    mb = B // M
    per_dev = []
    for d in devs:
        pos = torch.arange(T, dtype=torch.int64, device=d)[None, :]
        cos, sin = rope_tables(pos.expand(mb, T), cfg.head_dim,
                               cfg.rope_theta)
        per_dev.append((cos, sin, causal_mask(T, d)[None].expand(mb, T, T)))
    mbs = tokens.to(home).reshape(M, mb, T)

    def run_stage(p, x):
        cos, sin, mask = per_dev[p]
        for layer in stages[p]:
            x, _ = decoder_layer(layer, x, cos, sin, mask, cfg,
                                 attn_fn=attention)
        return x

    inbox = [None] * PP  # the activation each stage holds this tick
    acts = [None] * M
    for t in range(M + PP - 1):
        if t < M:
            # stage 0 injects microbatch t
            inbox[0] = embed(params, mbs[t], cfg).to(first)
        outs = [None] * PP
        for p in range(PP):
            if inbox[p] is not None:
                outs[p] = run_stage(p, inbox[p])
        # the last stage records microbatch t - PP + 1
        if outs[PP - 1] is not None:
            acts[t - (PP - 1)] = outs[PP - 1].to(home)
        # the hand-off: each stage's output moves one rank on
        inbox = [None] + [None if o is None else o.to(devs[p + 1])
                          for p, o in enumerate(outs[:-1])]
    x = rms_norm(torch.cat(acts, dim=0), params["norm"], cfg.rms_norm_eps,
                 offset=cfg.rmsnorm_offset)
    return lm_logits(params, x, cfg).to(first)


def make_pp_mesh(pp: int, devices=None) -> Mesh:
    """A 1-D ``pp`` mesh over the first ``pp`` of ``devices`` (every
    visible card by default; a list may repeat a device)."""
    return make_axis_mesh("pp", pp, devices)
