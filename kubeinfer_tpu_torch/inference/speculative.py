"""Speculative decoding: a draft model proposes, the target verifies.

Counterpart of ``kubeinfer_tpu/inference/speculative.py``: the dense
side-car engine the server's ``speculative`` route and the batcher's
draft groups use. ONE acceptance rule, greedy and sampled alike
(``stepper.spec_accept``): draft token i is accepted iff it equals the
token the TARGET itself draws at that position under the position-folded
noise schedule (a per-row key folded with the token's output index). The
emitted row is the target's own sample stream, so greedy output equals
vanilla greedy decoding for any draft, and sampled output follows the
target's sampling law exactly; the draft only decides how many target
draws one verify forward confirms. Repetition penalty stays excluded (the
server routes such requests away).

Each round runs a 2-token repair forward of the draft over [prev, cur]
(the slot a full-acceptance round left unprocessed), k - 1 more draft
steps, and ONE target forward over the k + 1 window [cur, draft_1 ..
draft_k]; every round emits 1 .. k + 1 tokens into a fixed [B, max_new +
k + 1] buffer at per-row offsets. Rejected cache entries are never
erased: the per-row offset moves back over them and the position-bounded
mask hides them. The round loop runs ``max_new - 1`` times (finished rows
keep stepping), as the reference's scan, and nothing is read back until
the tokens are.

The prefills go through ``engine.chunked_prefill`` (kernel #9 on the card
where ``flash_available`` holds); the rounds' forwards use the dense
``model.attention`` over the per-row caches, as the reference does.
Target and draft may be sharded on one tp mesh, as the server builds
them (``sharding.ShardedParams``; both caches split along n_kv).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from kubeinfer_tpu_torch.inference import prng
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.engine import (
    GenerationResult,
    chunked_prefill,
    make_caches,
    prefill_chunk_for,
    prepare_prompts,
)
from kubeinfer_tpu_torch.inference.model import (
    Params,
    engine_device,
    forward,
    params_dtype,
    params_to,
    rank_devices,
)
from kubeinfer_tpu_torch.inference.stepper import (
    RowFlags,
    sample_rows,
    spec_accept,
)


def _draw(logits, temperature, top_k, top_p, rng, counter, flags):
    """One per-row draw through the stepper's sampler: per-row warp knobs,
    per-row key folded with ``counter`` (the token's output index). The
    repetition penalty is off by construction (``flags.penalty`` False),
    so the seen set is never read."""
    B = logits.shape[0]
    ones = torch.ones((B,), dtype=torch.float32, device=logits.device)
    return sample_rows(logits, temperature, top_k, top_p, ones, None, rng,
                       counter, flags)


def _decode_mask(cache_len: int, offsets, q_width: int):
    """bool[B, q_width, cache_len]: row b's query at global position
    offsets[b] + i attends cache slots <= that position."""
    dev = offsets.device
    q_pos = offsets[:, None] + torch.arange(q_width, device=dev)[None, :]
    return torch.arange(cache_len, device=dev)[None, None, :] <= q_pos[:, :,
                                                                        None]


def _prefill_state(params, dparams, prompt, prompt_len, cfg, dcfg, max_new,
                   cache_len, k, prefill_chunk, eos_id, temperature, top_k,
                   top_p, rng_key, flags):
    """Prefill target and draft and build the round carry (round 0 emits
    the target's first token). Shared by the bulk path and the group
    path, which then run the same ``_one_round``."""
    B, T = prompt.shape
    dev = prompt.device
    tcaches = make_caches(cfg, B, cache_len, params_dtype(params), dev,
                          rank_devices(params))
    dcaches = make_caches(dcfg, B, cache_len, params_dtype(dparams), dev,
                          rank_devices(dparams))
    tcaches, t_logits = chunked_prefill(params, prompt, prompt_len, cfg,
                                        tcaches, prefill_chunk)
    dcaches, _ = chunked_prefill(dparams, prompt, prompt_len, dcfg, dcaches,
                                 prefill_chunk)
    # one key per ROW, counters folded per output index
    rows_rng = prng.split(rng_key, B)
    zeros = torch.zeros((B,), dtype=torch.int64, device=dev)
    first = _draw(t_logits, temperature, top_k, top_p, rows_rng, zeros,
                  flags)
    # every round may emit up to k + 1 tokens past max_new - 1 priors
    written = torch.zeros((B, max_new + k + 1), dtype=torch.int64,
                          device=dev)
    written[:, 0] = first
    counts = torch.ones((B,), dtype=torch.int64, device=dev)
    done = (first == eos_id) & (eos_id >= 0)
    # `first` sits AT each row's prompt length; the token before it is the
    # prompt's last real token
    offsets = prompt_len.long()
    rows = torch.arange(B, device=dev)
    prev = prompt[rows, torch.clamp(offsets - 1, 0, T - 1)].long()
    return (tcaches, dcaches, prev, first, offsets, written, counts, done,
            zeros.clone(), torch.zeros((), dtype=torch.int64, device=dev),
            rows_rng)


def _one_round(params, dparams, cfg, dcfg, k, max_new, eos_id, temperature,
               top_k, top_p, flags, carry):
    """One speculation round over the carry: k draft proposals, one target
    verify forward, acceptance, the buffer write."""
    (tcaches, dcaches, prev, cur, offsets, written, counts, done, accepted,
     rounds, rows_rng) = carry
    B = prev.shape[0]
    dev = prev.device
    cache_len = tcaches[0][0].shape[1]

    def draw(logits, counter):
        return _draw(logits, temperature, top_k, top_p, rows_rng, counter,
                     flags)

    # the draft: a 2-token repair window [prev, cur] at offsets - 1,
    # offsets (a full-acceptance round left the slot at offsets - 1
    # unprocessed), then k - 1 single steps; proposal i + 1 draws with the
    # key and counter of the target draw it guesses
    logits, dcaches = forward(
        dparams, torch.stack([prev, cur], dim=1), dcfg,
        positions=torch.stack([offsets - 1, offsets], dim=1),
        attn_mask=_decode_mask(cache_len, offsets - 1, 2),
        kv_caches=dcaches, cache_offset=offsets - 1)
    tok = draw(logits[:, 1], counts)
    drafts = [tok]
    off = offsets + 1
    for j in range(1, k):
        logits, dcaches = forward(
            dparams, tok[:, None], dcfg, positions=off[:, None],
            attn_mask=_decode_mask(cache_len, off, 1), kv_caches=dcaches,
            cache_offset=off)
        tok = draw(logits[:, 0], counts + j)
        drafts.append(tok)
        off = off + 1
    drafts = torch.stack(drafts, dim=1)  # [B, k]

    window = torch.cat([cur[:, None], drafts], dim=1)
    ar = torch.arange(k + 1, device=dev)
    t_logits, tcaches = forward(
        params, window, cfg, positions=offsets[:, None] + ar[None, :],
        attn_mask=_decode_mask(cache_len, offsets, k + 1), kv_caches=tcaches,
        cache_offset=offsets)
    # the target's own draws at every window position; on the accepted
    # prefix they are exactly what an unspeculated run draws there
    emitted = torch.stack([draw(t_logits[:, i], counts + i)
                           for i in range(k + 1)], dim=1)
    m = spec_accept(drafts, emitted) - 1  # accepted drafts, 0..k
    is_eos = (emitted == eos_id) & (eos_id >= 0)
    any_eos = is_eos.any(dim=1)
    first_eos = torch.where(any_eos, is_eos.int().argmax(dim=1) + 1, k + 1)
    n_emit = torch.minimum(m + 1, first_eos)
    n_emit = torch.where(done, 0, n_emit)
    hit_eos = any_eos & (first_eos <= m + 1)

    # the static row at each row's count (the reference's clamped
    # dynamic_update_slice); slots past n_emit are overwritten by the next
    # round's write, and the host slices to counts
    start = torch.clamp(counts, max=written.shape[1] - (k + 1))
    written.scatter_(1, start[:, None] + ar[None, :], emitted)

    counts = counts + n_emit
    accepted = accepted + torch.clamp(n_emit - 1, min=0)
    rounds = rounds + (~done).any().long()
    done = done | hit_eos | (counts >= max_new)
    rows = torch.arange(B, device=dev)
    new_cur = emitted[rows, torch.clamp(n_emit - 1, 0, k)]
    new_prev = torch.where(n_emit >= 2,
                           emitted[rows, torch.clamp(n_emit - 2, 0, k)], cur)
    prev = torch.where(n_emit > 0, new_prev, prev)
    cur = torch.where(n_emit > 0, new_cur, cur)
    offsets = offsets + n_emit
    return (tcaches, dcaches, prev, cur, offsets, written, counts, done,
            accepted, rounds, rows_rng)


def _vector_warp(B, temperature, top_k, top_p, device):
    """Scalar-or-[B] warp knobs as per-row device tensors, filled without
    a host-to-device copy, and the host flags the sampler gates on."""
    def row(x, dtype):
        a = np.broadcast_to(np.asarray(x), (B,))
        if np.all(a == a[0]):
            return torch.full((B,), a[0].item(), dtype=dtype, device=device)
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            device=device, dtype=dtype)

    flags = RowFlags.of(temperature, top_k, top_p, 1.0)
    return (row(temperature, torch.float32), row(top_k, torch.int32),
            row(top_p, torch.float32), flags)


@dataclass
class SpeculativeEngine:
    """Generation with draft-model speculation on one device
    (``device=None``: the CUDA card, raising when there is none), or over
    target and draft sharded on one mesh (``device`` the first rank's).
    ``generate`` matches Engine.generate's greedy output token for token;
    ``k`` is the speculation depth."""

    params: Params
    cfg: ModelConfig
    draft_params: Params
    draft_cfg: ModelConfig
    k: int = 4
    max_cache_len: int = 0
    device: object = None
    # diagnostics from the most recent generate(); None before any call
    last_stats: dict | None = None

    def __post_init__(self):
        if self.cfg.vocab_size != self.draft_cfg.vocab_size:
            raise ValueError(
                "draft and target must share a vocabulary "
                f"({self.draft_cfg.vocab_size} vs {self.cfg.vocab_size})")
        if self.k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {self.k}")
        if not self.max_cache_len:
            self.max_cache_len = self.cfg.max_position_embeddings
        self.device = engine_device(self.params, self.device)
        self.params = params_to(self.params, self.device)
        self.draft_params = params_to(self.draft_params, self.device)

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Whether a request fits the cache INCLUDING the k + 1 speculation
        slack (callers fall back to the plain engine when not)."""
        return prompt_len + max_new_tokens + self.k + 1 <= self.max_cache_len

    def _prefill(self, prompts, max_new_tokens, eos_id, temperature, top_k,
                 top_p, seed):
        B = len(prompts)
        padded, lens, cache_len = prepare_prompts(
            prompts, max_new_tokens, self.max_cache_len, slack=self.k + 1)
        dev = self.device
        temp, tk, tp, flags = _vector_warp(B, temperature, top_k, top_p,
                                           dev)
        state = _prefill_state(
            self.params, self.draft_params, torch.from_numpy(padded).to(dev),
            torch.from_numpy(lens).to(dev), self.cfg, self.draft_cfg,
            max_new_tokens, cache_len, self.k,
            prefill_chunk_for(B, int(padded.shape[1])), int(eos_id), temp,
            tk, tp, prng.PRNGKey(seed, dev), flags)
        return state, (temp, tk, tp, flags)

    def _round(self, state, max_new, eos_id, warp):
        temp, tk, tp, flags = warp
        return _one_round(self.params, self.draft_params, self.cfg,
                          self.draft_cfg, self.k, max_new, int(eos_id), temp,
                          tk, tp, flags, state)

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_id: int = -1, temperature: float = 0.0, seed: int = 0,
                 top_k: int = 0, top_p: float = 1.0) -> GenerationResult:
        """The bulk path: prefill and ``max_new_tokens - 1`` rounds, one
        readback."""
        if not prompts:
            return GenerationResult(np.zeros((0, 0), np.int32),
                                    np.zeros((0,), np.int32))
        with torch.inference_mode():
            state, warp = self._prefill(prompts, max_new_tokens, eos_id,
                                        temperature, top_k, top_p, seed)
            for _ in range(max_new_tokens - 1):
                state = self._round(state, max_new_tokens, eos_id, warp)
            return self._assemble(state[5], state[6], state[8], state[9],
                                  max_new_tokens, eos_id)

    def _assemble(self, written, counts, accepted, rounds, max_new,
                  eos_id) -> GenerationResult:
        """The output contract of both paths: counts clamped to max_new,
        each row sliced to its count and EOS-padded beyond it; records
        the diagnostics. One readback."""
        B = written.shape[0]
        host = torch.cat([written[:, :max_new], counts[:, None],
                          accepted[:, None], rounds.expand(B)[:, None]],
                         dim=1).cpu().numpy()
        toks = host[:, :max_new]
        counts = np.minimum(host[:, max_new], max_new).astype(np.int32)
        self.last_stats = {
            "accepted_drafts": host[:, max_new + 1].astype(np.int32),
            "rounds": int(host[0, max_new + 2]) if B else 0,
        }
        out = np.full((B, max_new), eos_id, np.int32)
        for b in range(B):
            out[b, :counts[b]] = toks[b, :counts[b]]
        return GenerationResult(out, counts)

    # -- the incremental group API: the same computation split at round
    # granularity, so a batcher's draft group interleaves with busy slots

    def start_group(self, prompts: list[list[int]], max_new_tokens: int = 32,
                    eos_id: int = -1, temperatures=0.0, top_ks=0,
                    top_ps=1.0, seed: int = 0) -> "SpecGroup":
        """Prefill a draft group with per-row warp knobs; the per-row keys
        derive from one group seed."""
        with torch.inference_mode():
            state, warp = self._prefill(prompts, max_new_tokens, eos_id,
                                        temperatures, top_ks, top_ps, seed)
        return SpecGroup(state=state, max_new=max_new_tokens, eos_id=eos_id,
                         warp=warp)

    def step_group(self, g: "SpecGroup") -> bool:
        """Advance one round; True when every row is done (or the round
        budget, max_new - 1, is spent). Reads back one flag."""
        if g.rounds_run >= g.max_new - 1:
            return True
        with torch.inference_mode():
            g.state = self._round(g.state, g.max_new, g.eos_id, g.warp)
        g.rounds_run += 1
        return bool(g.state[7].all())

    def finish_group(self, g: "SpecGroup") -> GenerationResult:
        """Read the group's buffers through the shared assembly."""
        return self._assemble(g.state[5], g.state[6], g.state[8],
                              g.state[9], g.max_new, g.eos_id)


@dataclass
class SpecGroup:
    """Device state of a live incremental draft group (``start_group``)."""

    state: tuple
    max_new: int
    eos_id: int
    warp: tuple  # per-row temperature, top_k, top_p tensors; host flags
    rounds_run: int = 0

    @property
    def accepted_drafts(self) -> int:
        """Draft tokens the target accepted across this group's rows, read
        off the group's own carry."""
        return int(self.state[8].sum())
