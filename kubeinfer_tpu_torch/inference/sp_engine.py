"""Sequence-parallel serving: ring-attention prefill, then the KV handed
off to the per-request engine's decode loop.

Counterpart of ``kubeinfer_tpu/inference/sp_engine.py``. A long prompt's
sequence axis splits over the mesh's ``sp`` ranks; ``model.sp_forward``
runs the decoder layer-major over the ranks' blocks with ring attention
(``ring_attention.py``: K/V blocks travel rank to rank, nothing ``[T,
T]``-sized exists), each rank writing its own K/V at global RoPE
positions into a local dense cache at offset 0, as the reference writes
through the model's standard cache path. The local caches are then
concatenated along T in rank order (per tp rank under tp) and widened to
the decode capacity, and the exact ``stepper.decode_scan`` of
``Engine.generate`` decodes from them (kernel #10 on each tp rank), with
the same sampling settings, seed and threefry key schedule.

Under a mesh with tp > 1 every sp rank runs its tp group's heads and MLP
lanes (``sharding.ShardedParams``), meets the group in
``sharding.all_reduce``, and each tp rank rings its own head shard over
the sp ranks (the reference's ``extra_vary=("tp",)``). The ring's fold
is plain PyTorch on the card too: the reference computes it outside any
Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from kubeinfer_tpu_torch.inference import prng
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.engine import (
    GenerationResult,
    prepare_prompts,
)
from kubeinfer_tpu_torch.inference.model import (
    Params,
    lm_logits,
    params_dtype,
    sp_forward,
)
from kubeinfer_tpu_torch.inference.sharding import (
    Mesh,
    ShardedParams,
    Sharded,
    sp_rank_params,
)
from kubeinfer_tpu_torch.observability import tracing

_TRACER = tracing.get_tracer("sp_engine")


def _local_caches(cfg: ModelConfig, B: int, T_loc: int, dtype, params):
    """One sp rank's zeroed local caches [B, T_loc, n_kv(/tp), D] a
    layer, ``Sharded`` along n_kv over its tp ranks when sharded."""
    devs = (params.devices if isinstance(params, ShardedParams)
            else [params["norm"].device])
    shape = (B, T_loc, cfg.num_key_value_heads // len(devs), cfg.head_dim)

    def side():
        pieces = [torch.zeros(shape, dtype=dtype, device=d) for d in devs]
        return pieces[0] if len(pieces) == 1 else Sharded(pieces, -2)

    return [(side(), side()) for _ in range(cfg.num_hidden_layers)]


def sp_prefill(params: Params, prompt: torch.Tensor,
               prompt_len: torch.Tensor, cfg: ModelConfig, mesh: Mesh,
               ranks: list | None = None):
    """Sequence-parallel prefill of ``prompt`` [B, T] (T divisible by the
    mesh's sp). Returns (per-layer caches [B, T, n_kv, D], ``Sharded``
    along n_kv under tp, on sp rank 0's tp devices; next_logits f32[B, V]
    at each row's last real position, on the first device). ``ranks``:
    ``sharding.sp_rank_params``' placement, made here when not given.

    Padding rows are left-aligned, so the causal mask alone keeps real
    queries off pad K/V; decode overwrites the pad positions before they
    become visible (chunked_prefill's contract)."""
    B, T = prompt.shape
    sp = mesh.shape["sp"]
    tp = mesh.shape.get("tp", 1)
    if T % sp:
        raise ValueError(f"prompt bucket {T} must divide by sp={sp}")
    if cfg.num_attention_heads % tp or cfg.num_key_value_heads % tp:
        raise ValueError(
            f"tp={tp} must divide attention heads "
            f"({cfg.num_attention_heads}) and kv heads "
            f"({cfg.num_key_value_heads})")
    T_loc = T // sp
    if ranks is None:
        ranks = sp_rank_params(params, mesh, cfg)
    first = mesh.devices[0, 0, 0]
    dtype = params_dtype(ranks[0])
    blocks = [prompt[:, s * T_loc:(s + 1) * T_loc].to(mesh.devices[0, 0, s])
              for s in range(sp)]
    local = [_local_caches(cfg, B, T_loc, dtype, p) for p in ranks]
    hidden = sp_forward(ranks, blocks, cfg, kv_caches=local)
    # the row's last real position lives on one rank: its hidden row is
    # taken there (the reference's psum of the one nonzero shard), and
    # the head runs once on the selected rows
    last = torch.clamp(prompt_len.to(first).long() - 1, 0, T - 1)
    rows = torch.arange(B, device=first)
    next_hidden = torch.zeros((B, cfg.hidden_size), dtype=dtype,
                              device=first)
    for s, x in enumerate(hidden):
        loc = last - s * T_loc
        in_rank = (loc >= 0) & (loc < T_loc)
        sel = x.to(first)[rows, torch.clamp(loc, 0, T_loc - 1)]
        next_hidden = torch.where(in_rank[:, None], sel, next_hidden)
    next_logits = lm_logits(ranks[0], next_hidden, cfg)

    devs = (ranks[0].devices if isinstance(ranks[0], ShardedParams)
            else [first])
    return handoff(local, devs), next_logits


def handoff(local: list, devs: list) -> list:
    """The ranks' local caches (``local[s]``: sp rank s's per-layer (k, v),
    ``Sharded`` along n_kv under tp) concatenated along T in sp rank
    order, tp rank r's pieces on ``devs[r]``: per-layer caches [B, T,
    n_kv, D] (``Sharded`` under tp)."""

    def cat(side, r, d):
        return torch.cat([(c[r] if isinstance(c, Sharded) else c).to(d)
                          for c in side], dim=1)

    caches = []
    for i in range(len(local[0])):
        pair = []
        for j in range(2):
            side = [rank[i][j] for rank in local]
            pieces = [cat(side, r, d) for r, d in enumerate(devs)]
            pair.append(pieces[0] if len(pieces) == 1
                        else Sharded(pieces, -2))
        caches.append(tuple(pair))
    return caches


def _expand(c, cache_len: int):
    """A handed-off cache [B, T, ...] (or its ``Sharded`` pieces) widened
    to the decode capacity, zeros past T."""
    if isinstance(c, Sharded):
        return Sharded([_expand(p, cache_len) for p in c], c.axis)
    buf = torch.zeros((c.shape[0], cache_len) + tuple(c.shape[2:]),
                      dtype=c.dtype, device=c.device)
    buf[:, :c.shape[1]] = c
    return buf


class SPEngine:
    """Long-prompt generation over a sequence-parallel mesh (its ``sp``
    axis at least 2; tp inside each sp rank where the params are sharded
    over the mesh's tp). ``fits`` gates the server's route: prompts
    below ``min_prompt`` take the other routes."""

    def __init__(self, params: Params, cfg: ModelConfig, mesh: Mesh,
                 max_cache_len: int = 0, min_prompt: int = 1024) -> None:
        if "sp" not in mesh.shape or mesh.shape["sp"] < 2:
            raise ValueError("SPEngine needs a mesh with an sp axis >= 2")
        self.cfg = cfg
        self.mesh = mesh
        self.sp = mesh.shape["sp"]
        self.device = mesh.devices[0, 0, 0]
        self.ranks = sp_rank_params(params, mesh, cfg)
        self.params = self.ranks[0]
        self.max_cache_len = max_cache_len or cfg.max_position_embeddings
        self.min_prompt = min_prompt

    def fits(self, prompt_len: int, max_new: int) -> bool:
        return (prompt_len >= self.min_prompt
                and prompt_len + max_new <= self.max_cache_len)

    def generate(
        self,
        prompts: list[list[int]],
        max_new_tokens: int = 32,
        eos_id: int = -1,
        temperature: float = 0.0,
        seed: int = 0,
        top_k: int = 0,
        top_p: float = 1.0,
        repetition_penalty: float = 1.0,
    ) -> GenerationResult:
        """One batch, ragged prompts exact: the sp prefill, the handoff,
        then ``decode_scan`` as ``Engine.generate`` runs it; one
        readback."""
        from kubeinfer_tpu_torch.inference.stepper import decode_scan

        if not prompts:
            return GenerationResult(np.zeros((0, 0), np.int32),
                                    np.zeros((0,), np.int32))
        with _TRACER.span("sp_engine.generate", batch=len(prompts),
                          max_new=max_new_tokens), torch.inference_mode():
            padded, lens, cache_len = prepare_prompts(
                prompts, max_new_tokens, self.max_cache_len)
            # the sequence blocks must be equal: widen the bucket to a
            # multiple of sp (buckets are powers of two, so only an sp
            # that is not one widens it)
            T = padded.shape[1]
            if T % self.sp:
                T2 = -(-T // self.sp) * self.sp
                padded = np.pad(padded, ((0, 0), (0, T2 - T)))
                cache_len = max(cache_len, T2)
            dev = self.device
            prompt = torch.from_numpy(padded).to(dev)
            prompt_len = torch.from_numpy(lens).to(dev)
            caches, next_logits = sp_prefill(
                self.params, prompt, prompt_len, self.cfg, self.mesh,
                ranks=self.ranks)
            caches = [(_expand(k, cache_len), _expand(v, cache_len))
                      for k, v in caches]
            toks, glens = decode_scan(
                self.params, self.cfg, caches, next_logits, prompt,
                prompt_len, max_new_tokens, cache_len, int(eos_id),
                float(temperature), int(top_k), float(top_p),
                float(repetition_penalty), prng.PRNGKey(seed, dev),
            )
            out = torch.cat([toks, glens[:, None]], dim=1).cpu().numpy()
        return GenerationResult(out[:, :-1].astype(np.int32),
                                out[:, -1].astype(np.int32))
