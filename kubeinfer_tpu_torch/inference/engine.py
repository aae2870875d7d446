"""Per-request generation engine: chunked prefill + a decode loop.

Counterpart of ``kubeinfer_tpu/inference/engine.py``. Prompts pad to
bucketed lengths, the prefill runs in fixed-size chunks against a dense
per-row KV cache (kernel #9 on the card, ``flash_attention_ragged``,
where ``flash_available`` holds; the dense attention elsewhere, as the
reference binds it), and the decode loop (``stepper.decode_scan``,
kernel #10) steps every row at its own offset. ``jax.lax.scan`` over chunks and over steps is a
Python loop here; the tokens are read back once per ``generate``.

Over tensor-parallel params (``sharding.ShardedParams``, as the server
builds them under ``--tensor-parallel-size``) the dense caches split along
``n_kv`` over the tp ranks (``make_caches(devices=...)``) and #9 and #10
run on each rank's heads.

Sampling is the reference's, noise included: threefry keys from
``prng`` (bit-equal to ``jax.random``), gumbel-argmax over filtered,
tempered logits. The reference's ``lax.cond`` fast paths (top-k, top-p,
repetition penalty, all-greedy) branch here on values the host already
holds, so no decode step reads anything back from the device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubeinfer_tpu_torch.inference import flash_attention as fa
from kubeinfer_tpu_torch.inference import prng
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.model import (
    Params,
    engine_device,
    forward,
    lm_logits,
    params_dtype,
    params_to,
    rank_devices,
)
from kubeinfer_tpu_torch.inference.sharding import Sharded
from kubeinfer_tpu_torch.observability import tracing

_TRACER = tracing.get_tracer("engine")

PROMPT_BUCKETS = (
    16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
    65536, 131072,
)
# Prefill processes the prompt in chunks of at least this many tokens;
# every bucket > 512 is a multiple of it.
PREFILL_CHUNK = 512
# Per-call prefill token budget (the reference's): bounds the transient
# [B, C, *] activations as the batch grows.
PREFILL_TOKEN_BUDGET = 2048


def prefill_chunk_for(batch: int, prompt_bucket: int) -> int:
    """Adaptive prefill chunk: as much of the token budget as one row's
    bucket can use, never below PREFILL_CHUNK, floored to a power of two
    so it divides the bucket."""
    per_row = max(PREFILL_TOKEN_BUDGET // max(batch, 1), 1)
    pow2 = 1 << (per_row.bit_length() - 1)
    return min(prompt_bucket, max(PREFILL_CHUNK, pow2))


def _bucket(n: int) -> int:
    for b in PROMPT_BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"prompt length {n} exceeds {PROMPT_BUCKETS[-1]}")


@dataclass
class GenerationResult:
    tokens: np.ndarray  # i32[B, max_new] generated ids (EOS-padded)
    lengths: np.ndarray  # i32[B] generated length per sequence


# Static cap for the top-k filter: requested k above it clips to it.
TOP_K_CAP = 64


def _any(x, pred) -> bool:
    """A host flag: ``pred`` over a Python number, a sequence or a numpy
    array, never a device tensor (that would be a host sync)."""
    if isinstance(x, torch.Tensor):
        raise TypeError("pass the host's copy of the sampling settings; a "
                        "device tensor would need a sync to branch on")
    return bool(np.any(pred(np.asarray(x))))


def _rows(x, lead, dtype, device) -> torch.Tensor:
    """A per-row setting as a tensor broadcast to ``lead``. A host number
    becomes a device fill, never a host-to-device copy (which would
    synchronise the host)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).expand(lead)
    return torch.full(lead, x, dtype=dtype, device=device)


def filter_logits(logits: torch.Tensor, top_k, top_p, *, topk_on=None,
                  topp_on=None) -> torch.Tensor:
    """Top-k then nucleus (top-p) filtering: non-kept logits -> -inf.

    ``top_k`` (<1 = off) and ``top_p`` (>=1 = off) are Python numbers or
    per-row tensors. The reference gates each filter behind ``lax.cond``
    on "any row has it on"; here the gate is a host flag: derived from
    ``top_k``/``top_p`` when they are host values, or passed by a caller
    that holds the host's copy of per-row tensors. The nucleus cut is a
    probability THRESHOLD, as in the reference (ties with the boundary
    token are all kept)."""
    V = logits.shape[-1]
    cap = min(TOP_K_CAP, V)
    lead = logits.shape[:-1]
    dev = logits.device
    if topk_on is None:
        topk_on = _any(top_k, lambda a: a >= 1)
    if topp_on is None:
        topp_on = _any(top_p, lambda a: a < 1.0)
    if topk_on:
        k = _rows(top_k, lead, torch.int64, dev)
        topvals = torch.topk(logits, cap, dim=-1).values  # descending
        kth = torch.gather(topvals, -1, (k - 1).clamp(0, cap - 1)[..., None])
        logits = torch.where((k >= 1)[..., None] & (logits < kth),
                             float("-inf"), logits)
    if topp_on:
        p = _rows(top_p, lead, torch.float32, dev)
        probs = torch.softmax(logits, dim=-1)
        sorted_p = torch.sort(probs, dim=-1, descending=True).values
        cum_excl = torch.cumsum(sorted_p, dim=-1) - sorted_p
        keep = cum_excl < p[..., None]
        # the argmax always survives, even for top_p <= 0
        keep[..., 0] = True
        thresh = torch.where(keep, sorted_p, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = torch.where((p < 1.0)[..., None] & (probs < thresh),
                             float("-inf"), logits)
    return logits


def seen_from_prompt(prompt: torch.Tensor, prompt_len: torch.Tensor,
                     vocab: int) -> torch.Tensor:
    """bool[B, V]: which vocab ids appear in each row's real prompt (pad
    columns excluded). A scatter-max, as the reference's."""
    B, T = prompt.shape
    valid = (torch.arange(T, device=prompt.device)[None, :]
             < prompt_len[:, None]).to(torch.uint8)
    seen = torch.zeros((B, vocab), dtype=torch.uint8, device=prompt.device)
    seen.scatter_reduce_(1, prompt.long(), valid, reduce="amax")
    return seen.bool()


def record_seen(seen: torch.Tensor, tokens: torch.Tensor, penalty_on: bool,
                keep: torch.Tensor | None = None) -> torch.Tensor:
    """Mark freshly generated ids as seen, IN PLACE, when any row has a
    repetition penalty (``penalty_on``, the host's copy of the
    reference's "any penalty != 1" gate). ``keep`` limits the update to
    active rows (the reference's ``where(keep, record_seen(...), seen)``)."""
    if penalty_on:
        rows = torch.arange(tokens.shape[0], device=tokens.device)
        new = True if keep is None else (seen[rows, tokens] | keep)
        seen[rows, tokens] = new
    return seen


def apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                             penalty, penalty_on: bool) -> torch.Tensor:
    """HF RepetitionPenaltyLogitsProcessor: seen ids get logit/penalty
    when positive, logit*penalty when negative, on raw logits; skipped
    when no row has a penalty (``penalty_on``)."""
    if not penalty_on:
        return logits
    pen = _rows(penalty, logits.shape[:-1], torch.float32,
                logits.device)[..., None]
    adj = torch.where(logits > 0, logits / pen, logits * pen)
    return torch.where(seen, adj, logits)


def gumbel_pick(raw_logits: torch.Tensor, filtered_scaled: torch.Tensor,
                key: torch.Tensor, temperature) -> torch.Tensor:
    """Greedy argmax of the RAW logits where temperature <= 0,
    gumbel-argmax of the filtered, tempered logits elsewhere. ``key`` is
    one key ``[2]`` (noise over the whole ``[B, V]``, as the per-request
    engine draws it) or one key per row ``[B, 2]`` (noise over ``[V]``
    per row, as the slot path draws it under vmap)."""
    greedy = torch.argmax(raw_logits, dim=-1)
    g = prng.gumbel(key, raw_logits.shape[key.dim() - 1:])
    sampled = torch.argmax(filtered_scaled + g, dim=-1)
    temp = _rows(temperature, raw_logits.shape[:-1], torch.float32,
                 raw_logits.device)
    return torch.where(temp > 0, sampled, greedy)


def gumbel_sample(logits: torch.Tensor, key: torch.Tensor,
                  temperature: float, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """Temperature sampling via the gumbel trick for host-scalar settings;
    temperature <= 0 is greedy (and draws no noise: the reference's pick
    selects the greedy token there)."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    # a divisor on the logits' device: true division on the card too (a
    # CPU scalar would let the CUDA kernel multiply by a reciprocal)
    scaled = logits / torch.full((), max(temperature, 1e-6),
                                 dtype=torch.float32, device=logits.device)
    filtered = filter_logits(scaled, top_k, top_p)
    return gumbel_pick(logits, filtered, key, temperature)


def prefill_attn(c0: int, prompt_len: torch.Tensor):
    """The chunked prefill's attention binding: #9 with the mask
    ``(s <= c0 + t) & (s < prompt_len[b])`` derived in the kernel."""

    def attn_fn(q, k, v, _mask):
        # under tp, once a rank: the lengths follow q to its device
        return fa.flash_attention_ragged(q, k, v, c0,
                                         prompt_len.to(q.device))

    return attn_fn


def chunked_prefill(params: Params, prompt: torch.Tensor,
                    prompt_len: torch.Tensor, cfg: ModelConfig, caches,
                    prefill_chunk: int):
    """Run the prompt through the model in fixed-size chunks, filling the
    caches in place; returns (caches, next_logits f32[B, V]) where
    next_logits[b] is the logits at row b's LAST real prompt position
    (the vocabulary head runs once, on those rows).

    The attention binding is the reference's: #9 (``prefill_attn``, the
    mask derived in the kernel, nothing [C, cache_len]-sized built) iff
    ``flash_available(C, cache_len, D)`` holds on the prompt's device;
    otherwise ``attention_auto`` over the dense mask ``(s <= c0 + t) &
    (s < prompt_len[b])``, which goes dense there (the two routes are
    equal within tolerance, not bitwise)."""
    B, T = prompt.shape
    cache_len = caches[0][0].shape[1] if caches else T
    C = min(T, prefill_chunk)
    last = torch.clamp(prompt_len.long() - 1, 0, T - 1)
    dev = prompt.device
    rows = torch.arange(B, device=dev)
    lens = prompt_len.to(torch.int32)
    use_flash = fa.flash_available(C, cache_len, cfg.head_dim, dev)
    pos = torch.arange(cache_len, device=dev)
    next_hidden = torch.zeros((B, cfg.hidden_size),
                              dtype=params_dtype(params), device=dev)
    for c0 in range(0, T, C):
        if use_flash:
            attn_fn, mask = prefill_attn(c0, lens), None
        else:
            q_pos = c0 + torch.arange(C, device=dev)
            mask = ((pos[None, None, :] <= q_pos[None, :, None])
                    & (pos[None, None, :] < prompt_len[:, None, None]))
            attn_fn = fa.attention_auto
        hidden, caches = forward(
            params, prompt[:, c0:c0 + C], cfg, attn_mask=mask,
            kv_caches=caches, cache_offset=c0, attn_fn=attn_fn,
            return_hidden=True,
        )
        in_chunk = (last >= c0) & (last < c0 + C)
        idx = torch.clamp(last - c0, 0, C - 1)
        next_hidden = torch.where(in_chunk[:, None], hidden[rows, idx],
                                  next_hidden)
    next_logits = lm_logits(params, next_hidden, cfg)
    return caches, next_logits


def make_caches(cfg: ModelConfig, B: int, cache_len: int, dtype, device,
                devices=None):
    """Zeroed dense per-row caches, one (k, v) pair a layer; with
    ``devices`` (the tp ranks' of sharded params) each side is
    ``Sharded`` along n_kv, rank r's heads on ``devices[r]``."""
    if devices is not None:
        shape = (B, cache_len, cfg.num_key_value_heads // len(devices),
                 cfg.head_dim)
        return [tuple(Sharded([torch.zeros(shape, dtype=dtype, device=d)
                               for d in devices], -2) for _ in range(2))
                for _ in range(cfg.num_hidden_layers)]
    shape = (B, cache_len, cfg.num_key_value_heads, cfg.head_dim)
    return [
        (torch.zeros(shape, dtype=dtype, device=device),
         torch.zeros(shape, dtype=dtype, device=device))
        for _ in range(cfg.num_hidden_layers)
    ]


def prepare_prompts(prompts: list[list[int]], max_new_tokens: int,
                    max_cache_len: int, slack: int = 0):
    """Validate, bucket, pad, and size the KV cache. Returns (padded
    i32[B, T_bucket], lens i32[B], cache_len)."""
    lens = np.asarray([len(p) for p in prompts], np.int32)
    if lens.min() < 1:
        raise ValueError("empty prompt")
    T = _bucket(int(lens.max()))
    need = int(lens.max()) + max_new_tokens + slack
    if need > max_cache_len:
        raise ValueError(
            f"prompt+new tokens ({need}) exceed the model's context "
            f"capacity ({max_cache_len})"
        )
    # never narrower than the prefill bucket; positions stay below
    # max_cache_len, extra columns are masked
    cache_len = max(T, _bucket(need))
    padded = np.zeros((len(prompts), T), np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p
    return padded, lens, cache_len


class Engine:
    """Generation front-end over a loaded model on one device
    (``device=None``: the CUDA card, raising when there is none), or over
    sharded params on their tp ranks (``device`` the first rank's)."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 max_cache_len: int = 0, device=None) -> None:
        self.device = engine_device(params, device)
        self.params = params_to(params, self.device)
        self.cfg = cfg
        self.max_cache_len = max_cache_len or cfg.max_position_embeddings

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
        """Batch generation, exact for ragged prompts: one shared prompt
        bucket, per-row offsets in the decode loop, one readback."""
        from kubeinfer_tpu_torch.inference.stepper import decode_scan

        if not prompts:
            return GenerationResult(np.zeros((0, 0), np.int32),
                                    np.zeros((0,), np.int32))
        B = len(prompts)
        with _TRACER.span("engine.generate", batch=B,
                          max_new=max_new_tokens), torch.inference_mode():
            padded, lens, cache_len = prepare_prompts(
                prompts, max_new_tokens, self.max_cache_len)
            dev = self.device
            prompt = torch.from_numpy(padded).to(dev)
            prompt_len = torch.from_numpy(lens).to(dev)
            caches = make_caches(self.cfg, B, cache_len,
                                 params_dtype(self.params), dev,
                                 rank_devices(self.params))
            caches, next_logits = chunked_prefill(
                self.params, prompt, prompt_len, self.cfg, caches,
                prefill_chunk_for(B, int(padded.shape[1])),
            )
            toks, glens = decode_scan(
                self.params, self.cfg, caches, next_logits, prompt,
                prompt_len, max_new_tokens, cache_len, int(eos_id),
                float(temperature), int(top_k), float(top_p),
                float(repetition_penalty), prng.PRNGKey(seed, dev),
            )
            out = torch.cat([toks, glens[:, None]], dim=1).cpu().numpy()
        return GenerationResult(out[:, :-1].astype(np.int32),
                                out[:, -1].astype(np.int32))
