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

``sharded_train_step`` and ``sp_train_step`` raise ``NotImplementedError``
naming the ROADMAP entry that ports them.
"""

from __future__ import annotations

import torch

from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.kv_blocks import device_scalar
from kubeinfer_tpu_torch.inference.model import Params, forward
from kubeinfer_tpu_torch.inference.weight_quant import params_weight_dtype

_PARALLEL = "ROADMAP Queue 1 entry 13: distributed.py and the parallel steps"


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
    if params_weight_dtype(params) != "bf16":
        raise ValueError("train_step: the tree holds int8 projection leaves,"
                         " which have no gradient; train a bf16/f32 tree")
    leaves = _leaves(params)
    before = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss = causal_lm_loss(params, tokens, cfg, attn_fn)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, flag in zip(leaves, before):
            p.requires_grad_(flag)
    _sgd(leaves, list(grads), lr)
    return params, loss.detach()


def sharded_train_step(mesh, cfg: ModelConfig):
    raise NotImplementedError(f"sharded_train_step: {_PARALLEL}")


def sp_train_step(mesh, cfg: ModelConfig, lr: float = 1e-3):
    raise NotImplementedError(f"sp_train_step: {_PARALLEL}")
