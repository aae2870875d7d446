"""Training step for the port's model (fine-tuning), in PyTorch.

Counterpart of ``kubeinfer_tpu/inference/train.py:24-69``: the causal-LM
loss through ``model.forward``'s DEFAULT attention binding
(``flash_attention.causal_attention_auto``), so on the card at aligned
shapes the step runs the differentiable flash route, #13 forward and #14
backward (``flash_attention.FlashCausalDiff``), and never builds [T, T]
scores; elsewhere it runs the dense ``attention``. Gradients come from
``torch.autograd.grad`` over the tree's leaves and the SGD update is
applied in place.

Where the reference's arithmetic would round differently in eager
PyTorch, the port follows the reference: the loss mean divides by a
device scalar (CUDA's ``mean`` multiplies by 1/N), and the learning rate
is rounded to the parameter dtype before the multiply (the reference's
``lr`` is a weakly typed Python float).

The parallel steps (``kubeinfer_tpu/inference/train.py:72-130``) run on
the single-process ``(dp, tp, sp)`` mesh of
``sharding.make_inference_mesh``. ``sharded_train_step`` runs the tp
forward (``forward`` over ``ShardedParams``) on each dp rank's slice of
the batch, each tp rank on its heads with the default attention binding,
so on the card at aligned shapes #13 and #14 run on every tp rank (the
reference pins the dense attention there: a Pallas call cannot partition
under GSPMD). ``sp_train_step`` differentiates the ring forward
(``sharding.forward_sequence_parallel``), plain PyTorch as the
reference's is plain jnp. Where ranks hold copies of one leaf (a
replicated leaf on each tp device, each dp or sp rank's tree on its own
devices), every copy is a leaf of the gradient: the leaf's gradient is
the sum of its copies', in rank order, and the same update is written to
every copy, so the copies stay equal.
"""

from __future__ import annotations

import torch

from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.kv_blocks import device_scalar
from kubeinfer_tpu_torch.inference.model import Params, forward, params_to
from kubeinfer_tpu_torch.inference.sharding import (
    Mesh,
    ShardedParams,
    _leaves as _spec_leaves,
    same_device,
    shard_params,
    sp_rank_logits,
    sp_rank_params,
)
from kubeinfer_tpu_torch.inference.weight_quant import params_weight_dtype


def _leaves(tree) -> list[torch.Tensor]:
    """The tree's tensors in a fixed order (dict keys, then list order)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _nll_mean(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross entropy, the one copy of the loss math. The
    sum is divided by a device tensor: true division, as the reference's
    mean, where a Python divisor would multiply by its reciprocal."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return nll.sum() / device_scalar(nll, float(nll.numel()))


def _sgd(params: Params, grads: Params, lr: float) -> Params:
    """SGD update p - lr * g, IN PLACE (the reference donates params and
    XLA updates them in place), each leaf keeping its dtype. ``lr`` is
    rounded to the leaf's dtype first, as the reference's weakly typed
    Python float is, and the product is rounded before the subtract."""
    with torch.no_grad():
        for p, g in zip(_leaves(params), _leaves(grads)):
            lr_t = torch.full((), lr, dtype=p.dtype, device=p.device)
            p.sub_(lr_t * g.to(p.dtype))
    return params


def causal_lm_loss(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attn_fn=None) -> torch.Tensor:
    """Mean next-token cross entropy over tokens [B, T + 1] (targets are
    the inputs shifted left), through ``forward``'s default binding when
    ``attn_fn`` is None."""
    logits, _ = forward(params, tokens[:, :-1], cfg, attn_fn=attn_fn)
    return _nll_mean(logits, tokens[:, 1:])


def train_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
               lr: float = 1e-3, attn_fn=None) -> tuple[Params, torch.Tensor]:
    """One SGD step: (params, loss). The reference donates ``params``;
    here they are updated IN PLACE and the same tree is returned. Each
    leaf requires grad for the step only. An int8 tree (``weight_quant``
    leaves) raises: the reference cannot differentiate one either."""
    _check_trainable(params, "train_step")
    leaves = _leaves(params)
    loss, grads = _value_and_grad(
        lambda: causal_lm_loss(params, tokens, cfg, attn_fn), leaves)
    _sgd(leaves, list(grads), lr)
    return params, loss


def _check_trainable(params, who: str) -> None:
    tree = params.shards[0] if isinstance(params, ShardedParams) else params
    if params_weight_dtype(tree) != "bf16":
        raise ValueError(f"{who}: the tree holds int8 projection leaves,"
                         " which have no gradient; train a bf16/f32 tree")


def _value_and_grad(loss_fn, leaves: list, allow_unused: bool = False):
    """(detached loss, gradients of ``leaves``): each leaf requires grad
    for the call only."""
    before = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn()
            grads = torch.autograd.grad(loss, leaves,
                                        allow_unused=allow_unused)
    finally:
        for p, flag in zip(leaves, before):
            p.requires_grad_(flag)
    return loss.detach(), grads


def _copy_groups(placements: list) -> list[list[torch.Tensor]]:
    """The copies of each logical leaf over several placements of one tree
    (plain trees, or ``ShardedParams`` whose replicated leaves count with
    every tp rank's), in rank order, each tensor once: ranks that share a
    device share their tensors."""
    groups: dict = {}
    for tree in placements:
        if isinstance(tree, ShardedParams):
            for r, shard in enumerate(tree.shards):
                for i, (spec, x) in enumerate(_spec_leaves(tree.specs,
                                                           shard)):
                    key = (i, r) if "tp" in spec else (i,)
                    groups.setdefault(key, []).append(x)
        else:
            for i, x in enumerate(_leaves(tree)):
                groups.setdefault((i,), []).append(x)
    out = []
    for copies in groups.values():
        seen: set = set()
        out.append([x for x in copies
                    if id(x) not in seen and not seen.add(id(x))])
    return out


def _step_on_copies(placements: list, loss_fn, lr: float) -> torch.Tensor:
    """One SGD step over every copy of every leaf: the gradients of a
    leaf's copies summed in rank order on the first copy's device (a copy
    the forward never read adds nothing), the update applied to the first
    copy and written to the others."""
    groups = _copy_groups(placements)
    leaves = [x for copies in groups for x in copies]
    loss, grads = _value_and_grad(loss_fn, leaves, allow_unused=True)
    it = iter(grads)
    for copies in groups:
        first = copies[0]
        total = None
        for g in (next(it) for _ in copies):
            if g is not None:
                g = g.to(first.device)
                total = g if total is None else total + g
        if total is None:
            total = torch.zeros_like(first)
        _sgd([first], [total], lr)
        with torch.no_grad():
            for x in copies[1:]:
                x.copy_(first)
    return loss


def _dp_placements(params: ShardedParams, mesh: Mesh) -> list:
    """Each dp rank's tree on its tp group ``devices[d, :, 0]``: rank 0's
    where the devices are the same, else a copy."""
    out = [params]
    for d in range(1, mesh.shape["dp"]):
        devs = list(mesh.devices[d, :, 0])
        if all(same_device(a, b) for a, b in zip(devs, params.devices)):
            out.append(params)
        else:
            out.append(ShardedParams(
                mesh=Mesh(mesh.devices[d:d + 1, :, :1], mesh.axis_names),
                specs=params.specs,
                shards=tuple(params_to(sh, dv)
                             for sh, dv in zip(params.shards, devs))))
    return out


def sharded_train_step(mesh: Mesh, cfg: ModelConfig, lr: float = 1e-3):
    """The train step for tp-sharded params and a dp-split batch.

    Returns ``step(params, tokens) -> (params, loss)``; place params with
    ``sharding.shard_params`` on ``mesh`` first (plain params are placed
    here, and the placed tree is returned). tokens [B, T + 1] split over
    dp (B divisible by it); the loss is the mean over the whole batch
    (``_nll_mean`` of every dp rank's logits, gathered on the first
    device). The params are updated in place and keep their placement."""
    dp = mesh.shape["dp"]

    def step(params, tokens: torch.Tensor):
        params = shard_params(params, mesh, cfg)
        _check_trainable(params, "sharded_train_step")
        B = tokens.shape[0]
        if B % dp:
            raise ValueError(f"batch {B} must divide by dp={dp}")
        b = B // dp
        dev = params.device
        placements = _dp_placements(params, mesh)

        def loss_fn():
            logits = torch.cat([
                forward(pl, tokens[d * b:(d + 1) * b, :-1].to(pl.device),
                        cfg)[0].to(dev)
                for d, pl in enumerate(placements)])
            return _nll_mean(logits, tokens[:, 1:].to(dev))

        return params, _step_on_copies(placements, loss_fn, lr)

    return step


def sp_causal_lm_loss(params, tokens: torch.Tensor, cfg: ModelConfig,
                      mesh: Mesh) -> torch.Tensor:
    """Causal-LM loss with the SEQUENCE split over the mesh's ``sp``
    ranks (the ring-attention forward); tokens [B, T + 1] with T
    divisible by sp."""
    from kubeinfer_tpu_torch.inference.sharding import (
        forward_sequence_parallel,
    )

    logits = forward_sequence_parallel(params, tokens[:, :-1], cfg, mesh)
    return _nll_mean(logits, tokens[:, 1:].to(logits.device))


def sp_train_step(mesh: Mesh, cfg: ModelConfig, lr: float = 1e-3):
    """SGD over the sequence-parallel loss: ``step(params, tokens) ->
    (params, loss)``. params live on sp rank 0's devices (plain where the
    mesh has tp == 1, else ``ShardedParams``, placed here when plain and
    returned); each other sp rank reads its copy (``sp_rank_params``), a
    leaf of the gradient like the rest. Updated in place."""

    def step(params, tokens: torch.Tensor):
        if mesh.shape["tp"] > 1:
            params = shard_params(params, mesh, cfg)
        _check_trainable(params, "sp_train_step")
        ranks = sp_rank_params(params, mesh, cfg)

        def loss_fn():
            logits = sp_rank_logits(ranks, tokens[:, :-1], cfg, mesh)
            return _nll_mean(logits, tokens[:, 1:].to(logits.device))

        return params, _step_on_copies(ranks, loss_fn, lr)

    return step
