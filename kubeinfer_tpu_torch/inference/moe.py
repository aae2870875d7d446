"""Mixture-of-experts block, and its expert-parallel form over an ``ep``
axis.

Counterpart of ``kubeinfer_tpu/inference/moe.py``: a top-k softmax router
and E SwiGLU experts stacked on a leading axis (``gate_proj``/``up_proj``
[E, H, F], ``down_proj`` [E, F, H], ``router`` [H, E]). ``moe_block`` is
the reference's dense form: every expert sees every token and the
routing weights, zero off each token's top k, weight the sum.
``moe_block_ep`` gives each ep rank ``E / ep`` experts on its device,
computes their weighted contribution for every token against the
replicated router, and sums the ranks' parts in ``sharding.all_reduce``
(the reference's single ``psum``; no token all-to-all).

All of it is plain PyTorch, cuBLAS products on the card: the reference
computes these einsums outside any Pallas kernel, so no kernel of the
repo stands behind them. Every expert runs on every token, ``E / top_k``
times the expert FLOPs of a routed dispatch, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.sharding import (
    Mesh,
    all_reduce,
    make_axis_mesh,
)

Params = dict


def init_moe_params(gen: torch.Generator, hidden: int, ffn: int,
                    n_experts: int, dtype=torch.float32,
                    device=None) -> Params:
    """Random expert-stacked weights (normal, 0.02 std) drawn from ``gen``
    (a ``torch.Generator`` on ``device``, as ``model.init_params`` draws
    its layers), in the order router, gate, up, down. The numbers differ
    from the reference's ``jax.random`` draw; tests carry its trees over
    instead."""
    dev = resolve_device(device)

    def dense(shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, 0.02, generator=gen)
        return w.to(dtype)

    return {
        "router": dense((hidden, n_experts)),
        # expert-stacked [E, ...]: the leading axis splits over ep
        "gate_proj": dense((n_experts, hidden, ffn)),
        "up_proj": dense((n_experts, hidden, ffn)),
        "down_proj": dense((n_experts, ffn, hidden)),
    }


def _router_weights(params: Params, x: torch.Tensor, top_k: int
                    ) -> torch.Tensor:
    """f32 [B, T, E] routing weights: a softmax over the logits at or above
    the k-th largest, zero elsewhere. ``>=`` keeps every expert tied at
    the threshold, as the reference's ``lax.top_k`` + ``>=`` does (a
    scatter of ``torch.topk``'s indices would keep exactly k)."""
    logits = x.float() @ params["router"].float()
    thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    masked = torch.where(logits >= thresh, logits,
                         torch.full((), float("-inf"), device=logits.device))
    return torch.softmax(masked, dim=-1)


def _experts(params: Params, x: torch.Tensor, w: torch.Tensor
             ) -> torch.Tensor:
    """The experts of ``params`` on every token of ``x`` [B, T, H],
    weighted by ``w`` [B, T, E_here] cast to x's dtype, summed."""
    gate = F.silu(torch.einsum("bth,ehf->betf", x, params["gate_proj"]))
    up = torch.einsum("bth,ehf->betf", x, params["up_proj"])
    y = torch.einsum("betf,efh->beth", gate * up, params["down_proj"])
    return torch.einsum("beth,bte->bth", y, w.to(x.dtype))


def moe_block(params: Params, x: torch.Tensor, top_k: int = 2
              ) -> torch.Tensor:
    """Dense form: every expert sees every token. [B, T, H] in x's
    dtype."""
    return _experts(params, x, _router_weights(params, x, top_k))


def shard_experts(params: Params, mesh: Mesh) -> list[Params]:
    """Each ep rank's experts on its device: rank r holds experts
    ``[r*E_loc, (r+1)*E_loc)`` of every stacked leaf and the whole router
    (a view where the rank's device is the leaf's own)."""
    devs = mesh.axis_devices("ep")
    ep = len(devs)
    E = params["gate_proj"].shape[0]
    if E % ep:
        raise ValueError(f"{E} experts do not divide over ep={ep}")
    n = E // ep
    return [{"router": params["router"].to(d),
             **{k: params[k].narrow(0, r * n, n).to(d)
                for k in ("gate_proj", "up_proj", "down_proj")}}
            for r, d in enumerate(devs)]


def moe_block_ep(params: Params, x: torch.Tensor, mesh: Mesh,
                 top_k: int = 2) -> torch.Tensor:
    """Expert-parallel form: the experts split over the mesh's ``ep``
    ranks (``shard_experts``), the ranks' parts summed in rank order on
    the first rank's device. Equal to ``moe_block`` up to the order of
    that sum."""
    parts = []
    for r, p in enumerate(shard_experts(params, mesh)):
        xr = x.to(p["router"].device)
        n = p["gate_proj"].shape[0]
        # routing needs every expert's logit: the router is replicated
        w = _router_weights(p, xr, top_k)[..., r * n:(r + 1) * n]
        parts.append(_experts(p, xr, w))
    return all_reduce(parts)


def make_ep_mesh(ep: int, devices=None) -> Mesh:
    """A 1-D ``ep`` mesh over the first ``ep`` of ``devices`` (every
    visible card by default; a list may repeat a device)."""
    return make_axis_mesh("ep", ep, devices)
