"""The decode stepper shared by the serving paths.

Counterpart of ``kubeinfer_tpu/inference/stepper.py``. Under tensor
parallelism (``sharding.EngineLayout``) the params are
``sharding.ShardedParams`` and the slot state's pool fields hold
``sharding.Sharded`` per-rank pieces along ``n_kv``; every function here
runs unchanged over them: ``model.forward`` runs each rank's heads
against its pieces through the same routers (the tables and lengths the
attention closures capture follow ``q`` to its rank's device), sampling
runs once on the gathered logits, and the int8 commit runs per rank.

- :func:`step_forward` is the one-token forward of a length-ragged batch.
  The dense route (per-row ``[B, S, ...]`` caches, the per-request
  engine) reads through kernel #10, the paged route (shared block pool +
  ``i32[B, max_blocks]`` tables, the continuous batcher) through #11, or
  through #12 when the pool is int8 (``kv_dtype="int8"``), each where
  the reference's guard holds (``decode_flash_available``,
  ``decode_blocks_available``); elsewhere both take the dense
  ``attention`` over the reference's mask.
- :func:`decode_window` is the continuous batcher's K-step window: K
  :func:`decode_body` steps in a Python loop over the slot state, whose
  pool is written in place; it returns the ``[n_slots, K]`` tokens
  without reading them back (the caller's readback is the window's one
  host sync).
- :func:`verify_window` is its speculative twin: a draft model proposes
  k tokens per live row (a repair forward, then k - 1 draft steps through
  kernel #10 on the draft's dense caches), one target forward scores the
  k + 1 window positions through #11 (or #12), and each row emits its
  accepted prefix (:func:`spec_accept`).
- :func:`decode_scan` is the per-request engine's loop.

Sampling keys are position-folded as in the reference (``sample_rows``
folds ``offset + 1``; the admit folds ``prompt_len``), so a K-step window
draws exactly the noise K single steps would. The reference's
``lax.cond`` gates (any row sampled, top-k, top-p, repetition penalty)
are host flags here (:class:`RowFlags`), built from the host's copy of
the slots' settings.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from kubeinfer_tpu_torch.inference import flash_attention as fa
from kubeinfer_tpu_torch.inference import prng
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.engine import (
    apply_repetition_penalty,
    filter_logits,
    gumbel_pick,
    gumbel_sample,
    record_seen,
    seen_from_prompt,
)
from kubeinfer_tpu_torch.inference.kv_blocks import quantize_blocks
from kubeinfer_tpu_torch.inference.model import Params, forward
from kubeinfer_tpu_torch.inference.sharding import Sharded

__all__ = [
    "SlotState", "init_slot_state", "sample_rows", "step_forward",
    "decode_body", "decode_window", "decode_scan", "WINDOW_BUCKETS",
    "RowFlags", "DraftState", "init_draft_state", "spec_accept",
    "verify_window",
]

# Decode-window horizons: the reference compiles one shape per bucket;
# here they bound the window the scheduler picks, as there.
WINDOW_BUCKETS = (1, 2, 4, 8)


@dataclass
class SlotState:
    """All device-resident decode state. The KV pool is SHARED across
    slots: row b's logical position p lives in
    ``caches_k[l][tables[b, p // bs], p % bs]``; block 0 is the reserved
    null block.

    ``kv_dtype="int8"`` pages are int8 with per-(block, kv head) f32
    scales (``scales_k``/``scales_v``) and a per-slot TAIL [B, 2, bs,
    n_kv, D] in the compute dtype (``tails_k``/``tails_v``): slot 0 is
    the row's current partial block (logical block offset // bs), slot 1
    the one a window may spill into. The step's K/V land in the tail,
    attention reads the tail for tiles at or past the tail base, and
    :func:`_commit_full_tails` quantizes a tail block into the pool once
    it fills. Each int8 field is one tensor over (K/V, layer), ``q8_*``,
    and the per-layer lists are views of it, so the commit is one set of
    ops over every layer. Under the bf16 pool the int8 lists stay empty
    and the ``q8_*`` fields None."""

    caches_k: list[torch.Tensor]  # L x [num_blocks, block_size, n_kv, D]
    caches_v: list[torch.Tensor]
    tables: torch.Tensor  # i32[B, max_blocks]
    last_token: torch.Tensor  # i64[B]
    offset: torch.Tensor  # i32[B] next cache position (= current length)
    active: torch.Tensor  # bool[B]
    temperature: torch.Tensor  # f32[B]; <=0 = greedy
    top_k: torch.Tensor  # i32[B]; <1 = disabled
    top_p: torch.Tensor  # f32[B]; >=1 = disabled
    rep_penalty: torch.Tensor  # f32[B]; 1.0 = disabled
    seen: torch.Tensor  # bool[B, V]
    rng: torch.Tensor  # i64[B, 2] per-slot threefry key data (u32 words)
    scales_k: list = dataclasses.field(default_factory=list)
    scales_v: list = dataclasses.field(default_factory=list)
    tails_k: list = dataclasses.field(default_factory=list)
    tails_v: list = dataclasses.field(default_factory=list)
    q8_pages: torch.Tensor | None = None  # int8[2, L, NB, bs, n_kv, D]
    q8_scales: torch.Tensor | None = None  # f32[2, L, NB, n_kv]
    q8_tails: torch.Tensor | None = None  # [2, L, B, 2, bs, n_kv, D]

    @property
    def quantized(self) -> bool:
        return self.q8_pages is not None

    @property
    def sharded(self) -> bool:
        """The pool is split over tp ranks (``EngineLayout.shard_state``)."""
        return isinstance(self.caches_k[0], Sharded)

    def rank_states(self) -> list["SlotState"]:
        """One state a tp rank: the pool fields hold that rank's pieces,
        every other field is this state's own tensor (on the first rank's
        device). ``[self]`` when the pool is whole."""
        if not self.sharded:
            return [self]

        def pick(xs, r):
            return [x[r] for x in xs]

        return [dataclasses.replace(
            self, caches_k=pick(self.caches_k, r),
            caches_v=pick(self.caches_v, r), scales_k=pick(self.scales_k, r),
            scales_v=pick(self.scales_v, r), tails_k=pick(self.tails_k, r),
            tails_v=pick(self.tails_v, r),
            q8_pages=None if self.q8_pages is None else self.q8_pages[r],
            q8_scales=None if self.q8_scales is None else self.q8_scales[r],
            q8_tails=None if self.q8_tails is None else self.q8_tails[r])
            for r in range(len(self.caches_k[0]))]


def init_slot_state(cfg: ModelConfig, n_slots: int, cache_len: int, dtype,
                    num_blocks: int, block_size: int, kv_dtype: str = "bf16",
                    device=None) -> SlotState:
    """``kv_dtype="bf16"`` stores pool pages in the compute ``dtype`` (the
    name is the CLI axis, as in the reference: f32 test engines stay
    f32); ``"int8"`` stores int8 pages, f32 scales starting at ONE (so
    the null block dequantizes to exactly 0) and zeroed tails in
    ``dtype``."""
    if kv_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_dtype must be 'bf16' or 'int8', got {kv_dtype!r}")
    L = cfg.num_hidden_layers
    n_kv, D = cfg.num_key_value_heads, cfg.head_dim
    shape = (num_blocks, block_size, n_kv, D)

    def z(shape_, dt):
        return torch.zeros(shape_, dtype=dt, device=device)

    if kv_dtype == "int8":
        pages = z((2, L, *shape), torch.int8)
        scales = torch.ones((2, L, num_blocks, n_kv), dtype=torch.float32,
                            device=device)
        tails = z((2, L, n_slots, 2, block_size, n_kv, D), dtype)
        pool = dict(caches_k=list(pages[0]), caches_v=list(pages[1]),
                    scales_k=list(scales[0]), scales_v=list(scales[1]),
                    tails_k=list(tails[0]), tails_v=list(tails[1]),
                    q8_pages=pages, q8_scales=scales, q8_tails=tails)
    else:
        pool = dict(caches_k=[z(shape, dtype) for _ in range(L)],
                    caches_v=[z(shape, dtype) for _ in range(L)])
    return SlotState(
        **pool,
        tables=z((n_slots, cache_len // block_size), torch.int32),
        last_token=z((n_slots,), torch.int64),
        offset=z((n_slots,), torch.int32),
        active=z((n_slots,), torch.bool),
        temperature=z((n_slots,), torch.float32),
        top_k=z((n_slots,), torch.int32),
        top_p=torch.ones((n_slots,), dtype=torch.float32, device=device),
        rep_penalty=torch.ones((n_slots,), dtype=torch.float32,
                               device=device),
        seen=z((n_slots, cfg.vocab_size), torch.bool),
        rng=z((n_slots, 2), torch.int64),
    )


@dataclass(frozen=True)
class RowFlags:
    """Host copies of the reference's "any row ..." ``lax.cond`` gates
    over a batch's sampling settings."""

    sampled: bool  # any temperature > 0
    top_k: bool  # any top_k >= 1
    top_p: bool  # any top_p < 1
    penalty: bool  # any repetition penalty != 1

    @classmethod
    def of(cls, temperature, top_k, top_p, rep_penalty) -> "RowFlags":
        return cls(
            sampled=bool(np.any(np.asarray(temperature) > 0)),
            top_k=bool(np.any(np.asarray(top_k) >= 1)),
            top_p=bool(np.any(np.asarray(top_p) < 1.0)),
            penalty=bool(np.any(np.asarray(rep_penalty) != 1.0)),
        )


def sample_rows(logits, temperature, top_k, top_p, rep_penalty, seen, rng,
                counter, flags: RowFlags) -> torch.Tensor:
    """Per-row sampling for the slot path: repetition penalty on the raw
    logits, then greedy rows take the argmax and sampled rows the
    gumbel-argmax of their filtered, tempered logits under the key
    ``fold_in(rng[b], counter[b])``. All-greedy batches draw no noise."""
    logits = apply_repetition_penalty(logits, seen, rep_penalty,
                                      flags.penalty)
    if not flags.sampled:
        return torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    filtered = filter_logits(scaled, top_k, top_p, topk_on=flags.top_k,
                             topp_on=flags.top_p)
    keys = prng.fold_in(prng.wrap_key_data(rng, impl="threefry2x32"),
                        counter)
    return gumbel_pick(logits, filtered, keys, temperature)


# --- the shared single-token forward ---------------------------------------


def step_forward(params: Params, cfg: ModelConfig, tok: torch.Tensor,
                 offset: torch.Tensor, kv_caches, cache_len: int,
                 block_tables: torch.Tensor | None = None):
    """One decode token for a length-ragged batch; returns (logits
    f32[B, V], kv_caches written in place). Both routes write the step's
    K/V at each row's own offset and attend positions < offset + 1: the
    routers' kernel (#10, or #11 / #12 on the pool) where its guard holds,
    else the dense route over the reference's mask, which is built only
    then (the guard reads shapes alone, once a call, on the host)."""
    lengths = (offset + 1).to(torch.int32)
    dev = tok.device
    # under tp the closures run once a rank, on its device: the tables
    # and lengths follow q there (the same tensors on one device)
    if block_tables is None:
        kernel = fa.decode_flash_available(cache_len, cfg.head_dim, dev)

        def attn_fn(q, k, v, mask):
            return fa.decode_attention_auto(q, k, v, lengths.to(q.device),
                                            mask)
    else:
        kernel = fa.decode_blocks_available(
            cache_len // block_tables.shape[1], cfg.head_dim, dev)
        quantized = bool(kv_caches) and isinstance(kv_caches[0][0], tuple)

        def attn_fn(q, kc, vc, mask):
            tables, lens = block_tables.to(q.device), lengths.to(q.device)
            if quantized:  # (pages, scales, tail) triples: #12
                return fa.decode_attention_blocks_q8_auto(
                    q, kc[0], vc[0], kc[1], vc[1], kc[2], vc[2], tables,
                    lens, mask)
            return fa.decode_attention_blocks_auto(q, kc, vc, tables, lens,
                                                   mask)
    mask = None if kernel else (
        torch.arange(cache_len, device=dev)[None, None, :]
        < lengths[:, None, None])  # [B, 1, S]
    logits, kv_caches = forward(
        params, tok[:, None], cfg, positions=offset[:, None].long(),
        attn_mask=mask, kv_caches=kv_caches, cache_offset=offset.long(),
        block_tables=block_tables, attn_fn=attn_fn,
    )
    return logits[:, 0], kv_caches


# --- the continuous batcher's window ---------------------------------------


def _zip_kv(state: SlotState) -> list:
    """Per-layer cache entries for ``forward``: (k, v) pool pairs, or
    ((pages, scales, tail), (pages, scales, tail)) under the int8 pool."""
    if state.quantized:
        return [((pk, sk, tk), (pv, sv, tv)) for pk, sk, tk, pv, sv, tv in
                zip(state.caches_k, state.scales_k, state.tails_k,
                    state.caches_v, state.scales_v, state.tails_v)]
    return list(zip(state.caches_k, state.caches_v))


def _commit_full_tails(pages, scales, tails, tables, old_off, new_off, keep,
                       block_size: int) -> None:
    """Quantize-on-commit, IN PLACE: rows whose step moved ``offset``
    across a block edge have just FILLED tail slot 0; it is quantized
    (``quantize_blocks``) into the row's pool block and scale row, and the
    tail shifts down a block (slot 0 <- slot 1, slot 1 <- zeros). Other
    rows write their block's current value back at its own index, so the
    duplicate indices of inactive rows (all naming null block 0) write
    identical values. ``pages`` [..., NB, bs, n_kv, D], ``scales`` [...,
    NB, n_kv] and ``tails`` [..., B, 2, bs, n_kv, D] share their leading
    (K/V, layer) dims: one set of ops covers them all. Under tp each is a
    ``Sharded``, and each rank commits its pieces on its device."""
    if isinstance(pages, Sharded):
        for p, s, t in zip(pages, scales, tails):
            d = p.device
            _commit_full_tails(p, s, t, tables.to(d), old_off.to(d),
                               new_off.to(d), keep.to(d), block_size)
        return
    B = old_off.shape[0]
    M = tables.shape[1]
    P = pages.view(-1, *pages.shape[-4:])
    S = scales.view(-1, *scales.shape[-2:])
    Tl = tails.view(-1, *tails.shape[-5:])
    rows = torch.arange(B, device=old_off.device)
    crossed = keep & (new_off // block_size > old_off // block_size)
    blk = tables[rows, torch.clamp(old_off // block_size, 0, M - 1)].long()
    qv, sv = quantize_blocks(Tl[:, :, 0])
    P[:, blk] = torch.where(crossed[None, :, None, None, None], qv, P[:, blk])
    S[:, blk] = torch.where(crossed[None, :, None], sv, S[:, blk])
    shifted = torch.cat([Tl[:, :, 1:], torch.zeros_like(Tl[:, :, :1])], dim=2)
    Tl.copy_(torch.where(crossed[None, :, None, None, None, None], shifted,
                         Tl))


def decode_body(params: Params, state: SlotState, cfg: ModelConfig,
                flags: RowFlags,
                commit: bool = True) -> tuple[SlotState, torch.Tensor]:
    """One token for every active slot; returns (state, tokens, -1 for
    inactive rows). Inactive rows flow through the math with their state
    kept; their pool write lands in the null block (all-null table).

    Under the int8 pool the step's K/V land in the tails and the step
    ends with the commit. ``commit=False`` skips it on a step where the
    caller's host offsets say that no active row crosses a block edge;
    there the commit would change nothing."""
    block_size = state.caches_k[0].shape[1]
    S = state.tables.shape[1] * block_size
    logits, _ = step_forward(
        params, cfg, state.last_token, state.offset, _zip_kv(state), S,
        block_tables=state.tables,
    )
    # counter offset + 1: the admit folded prompt_len (== the first
    # decode offset), so the bare offset would reuse its draw
    nxt = sample_rows(
        logits, state.temperature, state.top_k, state.top_p,
        state.rep_penalty, state.seen, state.rng, state.offset + 1, flags,
    )
    keep = state.active
    record_seen(state.seen, nxt, flags.penalty, keep=keep)
    new_off = torch.where(keep, state.offset + 1, state.offset)
    if state.quantized and commit:
        _commit_full_tails(state.q8_pages, state.q8_scales, state.q8_tails,
                           state.tables, state.offset, new_off, keep,
                           block_size)
    new_state = dataclasses.replace(
        state,
        last_token=torch.where(keep, nxt, state.last_token),
        offset=new_off,
    )
    return new_state, torch.where(keep, nxt, -1)


def decode_window(params: Params, state: SlotState, cfg: ModelConfig,
                  k: int, flags: RowFlags,
                  commit_steps=None) -> tuple[SlotState, torch.Tensor]:
    """K decode steps; returns (state, i64[B, K]) without a readback.
    ``active`` never changes mid-window (retirement is host work): a row
    whose EOS lands mid-window keeps stepping inside its own blocks, and
    the host masks its tail tokens. ``commit_steps`` (K bools, default
    all True) says on which steps the int8 pool's commit runs."""
    toks = []
    for j in range(k):
        commit = True if commit_steps is None else bool(commit_steps[j])
        state, t = decode_body(params, state, cfg, flags, commit)
        toks.append(t)
    return state, torch.stack(toks, dim=1)


# --- speculative verify window ---------------------------------------------


@dataclass
class DraftState:
    """The draft model's state for the verify window, one row per slot:
    DENSE per-row caches ``L_d x [n_slots, Ld, n_kv_d, D_d]`` (the draft
    is small; paging it would couple its blocks to the pool's) and
    ``prev``, the token at target position ``offset - 1``. At rest
    (target offset o) the committed draft KV covers positions 0 .. o-2;
    each window's repair forward rewrites o-1 and o before any read."""

    caches_k: list[torch.Tensor]  # L_d x [n_slots, Ld, n_kv_d, D_d]
    caches_v: list[torch.Tensor]
    prev: torch.Tensor  # i64[n_slots]


def init_draft_state(dcfg: ModelConfig, n_slots: int, cache_len: int,
                     dtype, device=None) -> DraftState:
    # Ld == cache_len: the propose steps' deepest write is o + k - 1, and
    # the batcher verifies only rows with prompt + max_new + k <= cache_len
    shape = (n_slots, cache_len, dcfg.num_key_value_heads, dcfg.head_dim)
    L = dcfg.num_hidden_layers
    return DraftState(
        caches_k=[torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(L)],
        caches_v=[torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(L)],
        prev=torch.zeros((n_slots,), dtype=torch.int64, device=device),
    )


def spec_accept(drafts: torch.Tensor, target_toks: torch.Tensor
                ) -> torch.Tensor:
    """THE acceptance rule: draft i survives iff it equals the target's own
    draw at its position and every earlier draft survived (a cumprod of
    matches); the target's draw after the last survivor is always
    emitted. ``drafts`` [B, k], ``target_toks`` [B, k + 1]; returns
    n_emit = accepted + 1 in [1, k + 1]."""
    k = drafts.shape[1]
    agree = (drafts == target_toks[:, :k]).long()
    return torch.cumprod(agree, dim=1).sum(dim=1) + 1


def verify_window(params: Params, state: SlotState, dparams: Params,
                  dstate: DraftState, cfg: ModelConfig, dcfg: ModelConfig,
                  k: int, flags: RowFlags
                  ) -> tuple[SlotState, DraftState, torch.Tensor]:
    """The speculative twin of :func:`decode_window`: every live row gets
    k draft proposals, one target forward scores the k + 1 window
    positions through the paged router (#11, or #12 on the int8 pool, at
    T = k + 1, where its guard holds; else the dense route over the
    reference's window mask), and each row emits its accepted prefix.
    Returns (state,
    dstate, toks i64[B, k + 1]): row b's first n_emit entries are its
    tokens, the rest -1. Nothing is read back (the caller's readback is
    the window's one host sync); the pool, the draft caches, ``seen`` and
    the int8 tails are written in place.

    The emitted tokens are the target's own draws under the position-
    folded keys the single-step path uses (position p -> counter p), with
    ``seen`` threaded along the accepted prefix only, so the stream
    equals :func:`decode_window`'s whatever the draft proposes. Rejected
    positions' KV stays past the new offset, where the next window
    overwrites it; inactive rows (all-null tables) emit nothing and keep
    their state."""
    B = state.last_token.shape[0]
    dev = state.last_token.device
    block_size = state.caches_k[0].shape[1]
    S = state.tables.shape[1] * block_size
    # a 0-layer (bigram) draft has no KV: Ld only shapes the repair mask
    Ld = dstate.caches_k[0].shape[1] if dcfg.num_hidden_layers > 0 else S
    o = state.offset.long()
    T = k + 1
    rows = torch.arange(B, device=dev)
    penalty = flags.penalty

    def draw(logits, seen, counter):
        return sample_rows(logits, state.temperature, state.top_k,
                           state.top_p, state.rep_penalty, seen, state.rng,
                           counter, flags)

    # --- draft propose: the repair forward over [prev, last_token] at
    # positions o-1, o (dense attention), then k - 1 draft steps (#10) ---
    rep_tok = torch.stack([dstate.prev, state.last_token], dim=1)
    rep_pos = torch.stack([o - 1, o], dim=1)
    rep_mask = (torch.arange(Ld, device=dev)[None, None, :]
                <= rep_pos[:, :, None])
    dcaches = list(zip(dstate.caches_k, dstate.caches_v))
    dlogits, _ = forward(dparams, rep_tok, dcfg, positions=rep_pos,
                         attn_mask=rep_mask, kv_caches=dcaches,
                         cache_offset=o - 1)
    # the draft's own seen set: record_seen writes in place, and the
    # slot's set must only ever see the accepted prefix. Every row marks
    # its proposal (a device mask: a host True would be copied over)
    dseen = state.seen.clone() if penalty else state.seen
    every = torch.ones_like(state.active)
    tok = draw(dlogits[:, 1], dseen, o + 1)
    record_seen(dseen, tok, penalty, keep=every)
    drafts = [tok]
    for i in range(1, k):
        lg, _ = step_forward(dparams, dcfg, tok, o + i, dcaches, Ld)
        tok = draw(lg, dseen, o + i + 1)
        record_seen(dseen, tok, penalty, keep=every)
        drafts.append(tok)
    drafts = torch.stack(drafts, dim=1)  # [B, k]

    # --- the fused verify: the window [last, d_1 .. d_k] at positions
    # o .. o + k, scattered before it is attended (lengths o + T) ---
    window = torch.cat([state.last_token[:, None], drafts], dim=1)
    positions = o[:, None] + torch.arange(T, device=dev)[None, :]
    lengths = (o + T).to(torch.int32)
    if state.quantized:
        # both routes derive the window's tail base (lengths - T) // bs
        def attn_fn(q, kc, vc, mask):
            return fa.decode_attention_blocks_q8_auto(
                q, kc[0], vc[0], kc[1], vc[1], kc[2], vc[2],
                state.tables.to(q.device), lengths.to(q.device), mask)
    else:
        def attn_fn(q, kp, vp, mask):
            return fa.decode_attention_blocks_auto(
                q, kp, vp, state.tables.to(q.device), lengths.to(q.device),
                mask)
    # the reference's dense-route mask, built only where the kernel's
    # guard fails
    mask = None if fa.decode_blocks_available(
        block_size, cfg.head_dim, dev) else (
        torch.arange(S, device=dev)[None, None, :] <= positions[:, :, None])
    logits, _ = forward(params, window, cfg, positions=positions,
                        attn_mask=mask, kv_caches=_zip_kv(state),
                        cache_offset=o, block_tables=state.tables,
                        attn_fn=attn_fn)

    # --- acceptance: logits[:, i] predicts position o + 1 + i, drawn with
    # counter o + 1 + i; seen follows the alive prefix ---
    alive = state.active
    target = []
    for i in range(T):
        t = draw(logits[:, i], state.seen, o + 1 + i)
        record_seen(state.seen, t, penalty, keep=alive)
        if i < k:
            alive = alive & (drafts[:, i] == t)
        target.append(t)
    target = torch.stack(target, dim=1)  # [B, T]
    keep = state.active
    n_emit = torch.where(keep, spec_accept(drafts, target), 0)

    # --- boundary state: the token at o' = o + n_emit is target[n_emit-1],
    # the next repair's prev target[n_emit-2] (or the old last token) ---
    last_new = target[rows, torch.clamp(n_emit - 1, 0, k)]
    prev_new = torch.where(n_emit >= 2,
                           target[rows, torch.clamp(n_emit - 2, 0, k)],
                           state.last_token)
    new_off = torch.where(keep, state.offset + n_emit.to(torch.int32),
                          state.offset)
    if state.quantized:
        # a window spans at most one block edge (T <= bs): the rows that
        # crossed commit their filled tail slot 0
        _commit_full_tails(state.q8_pages, state.q8_scales, state.q8_tails,
                           state.tables, state.offset, new_off, keep,
                           block_size)
    new_state = dataclasses.replace(
        state, last_token=torch.where(keep, last_new, state.last_token),
        offset=new_off)
    new_dstate = dataclasses.replace(
        dstate, prev=torch.where(keep, prev_new, dstate.prev))
    toks = torch.where(torch.arange(T, device=dev)[None, :]
                       < n_emit[:, None], target, -1)
    return new_state, new_dstate, toks


# --- the per-request loop --------------------------------------------------


def decode_scan(params: Params, cfg: ModelConfig, caches,
                next_logits: torch.Tensor, prompt: torch.Tensor,
                prompt_len: torch.Tensor, max_new: int, cache_len: int,
                eos_id: int, temperature: float, top_k: int, top_p: float,
                rep_penalty: float, rng_key: torch.Tensor):
    """The per-request engine's decode loop: sample from ``next_logits``,
    then single-token steps against the dense caches, each row at its own
    offset. The key schedule is the reference's: split the call's key
    into (k0, rest), then split rest into max_new - 1 step keys. Returns
    (tokens i64[B, max_new], generated lengths i64[B]) on the device."""
    penalty_on = rep_penalty != 1.0

    def sample(logits, key, seen):
        logits = apply_repetition_penalty(logits, seen, rep_penalty,
                                          penalty_on)
        return gumbel_sample(logits, key, temperature, top_k, top_p)

    seen = seen_from_prompt(prompt, prompt_len, cfg.vocab_size)
    k0, krest = prng.split(rng_key)
    first = sample(next_logits, k0, seen)
    record_seen(seen, first, penalty_on)
    eos_on = eos_id >= 0
    done = (first == eos_id) & eos_on
    toks = [first]
    if max_new > 1:
        keys = prng.split(krest, max_new - 1)
        tok, offset = first, prompt_len.to(torch.int32)
        for i in range(max_new - 1):
            logits, caches = step_forward(params, cfg, tok, offset, caches,
                                          cache_len)
            nxt = sample(logits, keys[i], seen)
            record_seen(seen, nxt, penalty_on)
            newly_done = (nxt == eos_id) & eos_on
            nxt = torch.where(done, eos_id, nxt)
            done = done | newly_done
            toks.append(nxt)
            tok, offset = nxt, offset + 1
    out = torch.stack(toks, dim=1)
    is_eos = (out == eos_id) & eos_on
    first_eos = torch.where(is_eos.any(dim=1), is_eos.int().argmax(dim=1) + 1,
                            max_new)
    return out, first_eos
