"""Continuous batching: requests join and leave a shared decode batch.

Counterpart of ``kubeinfer_tpu/inference/batching.py``:

- A fixed pool of B decode **slots** over a shared PAGED KV pool
  (per-layer ``[num_blocks, block_size, n_kv, D]`` tensors and an
  ``i32[B, max_blocks]`` block table per slot). Every allocation,
  refcount and free is host-side (``kv_blocks``), between device steps.
- ``stepper.decode_window`` advances every active slot K tokens per
  scheduler pass; attention reads the pool through the tables with
  kernel #11 (``flash_attention.decode_attention_blocks``). The window's
  token readback is its one host sync.
- New requests prefill into a free slot while other slots keep
  decoding. The radix cache matches the longest full-block prompt
  prefix already in the pool; matched blocks join the slot's table by
  refcount and the prefill starts at the matched offset. Long novel
  suffixes may prefill in fixed chunks (``prefill_chunk_blocks``), one
  chunk per scheduler pass.

The admit and chunk prefills gather the row's logical view through its
table, run the dense ``model.attention`` forward over it (as the
reference does on every backend: no kernel runs there), and write back
only the blocks the admit owns, in place.

Precision axes, as in the reference: ``kv_dtype="int8"`` keeps the pool
in int8 with per-(block, kv head) scales and a per-slot tail pair
(``stepper.SlotState``): the admit gathers a dequantized view, quantizes
its owned FULL prompt blocks into the pool and seeds the slot's tail
with the partial block; a chunk quantizes every owned block; the decode
window's commit quantizes each tail block as it fills (kernel #12 reads
the pool). ``weight_dtype="int8"`` takes a quantized tree, or quantizes
a plain one here (kernel #15 runs every projection).

Speculative decoding, two routes as in the reference:

- ``spec_draft=(dparams, dcfg)``: a draft model rides the paged batch.
  Each admit reserves ``spec_k`` positions of verify slack and prefills
  the slot's row of the draft's dense caches (``_admit_draft``); while
  every decoding row has both, a pass runs ``stepper.verify_window``
  (k draft proposals per row, one T = k + 1 target forward through #11
  or #12) instead of a decode window, and the host emits each row's
  accepted prefix, truncated at EOS or the budget (a truncation always
  lands on a retirement).
- ``speculative=SpeculativeEngine``: without ``spec_draft``, eligible
  requests (fresh, no repetition penalty, fitting the draft cache) decode
  in an incremental draft group (``start_group``/``step_group``), one
  round per scheduler pass beside the slots.

Disaggregated prefill, as in the reference: ``submit(export_kv=True)``
captures the request's committed full-block pages right after its admit
(one device-to-host copy per side), and ``import_prefix`` stages a
fetched prefix for the scheduler thread, which writes the pages into
fresh pool blocks in place and caches them in the radix trie, so the
request that wants them admits warm.

Preemption, load shedding and live-session migration, as in the
reference:

- ``preemption=PreemptionPolicy``: a waiter whose queue wait burns the
  engine's private queue-wait SLO parks the youngest decoding row
  between windows (``_park_slot``): its committed full blocks go into
  the radix trie, and its readmit later matches them warm and
  recomputes only the tail, drawing the same samples by the
  position-folded key schedule.
- ``queue_depth_limit``: ``submit`` refuses (``EngineOverloadedError``)
  once the queue, the holdover and the parked rows hold that many.
- ``drain()``: ``submit`` refuses (``EngineDrainingError``), pending
  requests complete as migrated, and each live slot streams its
  committed blocks through ``migration_sink``, one chunk per scheduler
  pass with decode windows between, then parks-for-migrate
  (``req.migrated``). ``submit(resume_tokens=...)`` finishes such a
  session on another engine.

Instrumentation, as in the reference: a ``StepProfiler`` record per
device dispatch (``self.profiler``), a ``FlightRecorder`` ring of the
scheduler's decisions (``self.flight``, dumped to the log when
``_fail_inflight`` fails waiters), the ``engine.*`` spans of each
request's timeline, ``slo_burn()`` and ``stats_summary()``. None of it
reads the device: the records take the host clock around the dispatches
the scheduler already makes, and the decode and verify windows are timed
by the stamps around their one readback.

Tensor parallelism, as in the reference (``layout=EngineLayout(tp,
mesh)``, ``sharding.py``): the params are sharded per the Megatron specs
and the pool split along ``n_kv`` over the tp ranks, every block whole on
every rank, so block ids, the tables and every host structure stay those
of tp=1. One process and this one scheduler thread drive every rank: the
admit gathers, forwards and writes back each rank's heads, the windows
run ``model.forward`` over the sharded params (the kernels per rank),
imports split the wire's pages along ``n_kv`` and exports concatenate
the ranks' pieces, so the wire bytes are tp=1's. A draft on the verify
route is replicated (one plain copy on the first rank's device), as the
reference replicates it. ``tp == 1`` is meshless and runs the
single-device tensors and code path.

The reference's racecheck wrappers are not ported (the locks are plain
``threading`` primitives).
"""

from __future__ import annotations

import collections
import itertools
import logging
import queue
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference import prng
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.engine import _bucket, record_seen
from kubeinfer_tpu_torch.inference.kv_blocks import (
    BlockPool,
    RadixCache,
    dequantize_blocks,
    prefix_fingerprints,
    quantize_blocks,
)
from kubeinfer_tpu_torch.inference.model import (
    Params,
    forward,
    param_bytes,
    params_dtype,
    params_to,
)
from kubeinfer_tpu_torch.inference.sharding import (
    EngineLayout,
    Sharded,
    ShardedParams,
    rank_piece,
    same_device,
    unshard_params,
)
from kubeinfer_tpu_torch.inference.stepper import (
    WINDOW_BUCKETS,
    DraftState,
    RowFlags,
    SlotState,
    decode_window,
    init_draft_state,
    init_slot_state,
    sample_rows,
    verify_window,
)
from kubeinfer_tpu_torch.inference.weight_quant import (
    params_weight_dtype,
    quantize_params,
)
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.observability.flightrecorder import FlightRecorder
from kubeinfer_tpu_torch.observability.slo import SLOMonitor, SLOObjective
from kubeinfer_tpu_torch.observability.stepprof import StepProfiler

log = logging.getLogger(__name__)

_TRACER = tracing.get_tracer("engine")
# per-token events kept on one engine.decode span, as in the reference
_MAX_TOKEN_EVENTS = 128

# pool block width (tokens), as in the reference; engines whose
# cache_len is smaller clamp down
DEFAULT_BLOCK_SIZE = 128

def _on(t: torch.Tensor, rank_state: SlotState) -> torch.Tensor:
    """``t`` on a rank state's pool device (the same tensor there)."""
    return t.to(rank_state.caches_k[0].device)


def _gather_view(state: SlotState, table_row: torch.Tensor):
    """Per-layer (k, v) logical views ``[1, S, n_kv, D]`` of one row,
    gathered through its table (a copy: the forward writes into it).
    Under the int8 pool the views dequantize the committed blocks into
    the tails' dtype, and are slices of one [2, L, M, bs, n_kv, D]
    tensor, returned second (None under the bf16 pool). Under tp each
    rank gathers its heads: the views are ``Sharded`` along n_kv."""
    if state.sharded:
        per = [_gather_view(rs, _on(table_row, rs))
               for rs in state.rank_states()]
        caches = [(Sharded([p[0][l][0] for p in per], -2),
                   Sharded([p[0][l][1] for p in per], -2))
                  for l in range(len(per[0][0]))]
        view = None if per[0][1] is None else Sharded([p[1] for p in per],
                                                      -2)
        return caches, view
    nb, bs, n_kv, D = state.caches_k[0].shape
    S = table_row.shape[0] * bs
    if state.quantized:
        view = dequantize_blocks(state.q8_pages[:, :, table_row],
                                 state.q8_scales[:, :, table_row],
                                 state.q8_tails.dtype)
        return [(view[0, l].reshape(1, S, n_kv, D),
                 view[1, l].reshape(1, S, n_kv, D))
                for l in range(view.shape[1])], view
    return [
        (ck[table_row].reshape(1, S, n_kv, D),
         cv[table_row].reshape(1, S, n_kv, D))
        for ck, cv in zip(state.caches_k, state.caches_v)
    ], None


def _put_owned(state: SlotState, caches, table_row: torch.Tensor,
               own_idx: torch.Tensor) -> None:
    """Write the row's updated view back into the pool, IN PLACE, for
    the blocks this admit owns only: shared prefix blocks are never
    rewritten (copy-on-write), the null padding is left alone. Under tp
    each rank writes its heads."""
    if state.sharded:
        for r, rs in enumerate(state.rank_states()):
            _put_owned(rs, [rank_piece(c, r) for c in caches],
                       _on(table_row, rs), _on(own_idx, rs))
        return
    nb, bs, n_kv, D = state.caches_k[0].shape
    M = table_row.shape[0]
    blocks = table_row[own_idx]
    for ck, cv, (vk, vv) in zip(state.caches_k, state.caches_v, caches):
        ck[blocks] = vk.reshape(M, bs, n_kv, D)[own_idx]  # in place
        cv[blocks] = vv.reshape(M, bs, n_kv, D)[own_idx]  # in place


def _put_quantized(state: SlotState, view: torch.Tensor,
                   table_row: torch.Tensor, own_idx: torch.Tensor) -> None:
    """Quantize-on-commit of the int8 pool, IN PLACE: the blocks
    ``table_row[own_idx]`` of the row's updated view [2, L, M, bs, n_kv,
    D] are quantized (``quantize_blocks``, per block) into the pages and
    scales of every layer at once; under tp each rank its heads (the
    scales are per kv head, so the codes are tp=1's)."""
    if state.sharded:
        for rs, v in zip(state.rank_states(), view):
            _put_quantized(rs, v, _on(table_row, rs), _on(own_idx, rs))
        return
    blocks = table_row[own_idx]
    qv, sv = quantize_blocks(view[:, :, own_idx])
    state.q8_pages[:, :, blocks] = qv
    state.q8_scales[:, :, blocks] = sv


def _seed_tail(state: SlotState, view: torch.Tensor, block: int,
               slot: int) -> None:
    """The int8 admit's tail seed, IN PLACE: logical block ``block`` of
    the row's updated view into the slot's tail slot 0, zeroed spill room
    in slot 1 (each rank its heads under tp)."""
    if state.sharded:
        for rs, v in zip(state.rank_states(), view):
            _seed_tail(rs, v, block, slot)
        return
    t0 = view[:, :, block]
    state.q8_tails[:, :, slot] = torch.stack([t0, torch.zeros_like(t0)],
                                             dim=2)


def _admit_slot(params: Params, state: SlotState, suffix: torch.Tensor,
                suffix_len: int, start: int, prompt_len: int,
                cfg: ModelConfig, slot: int, table_row: torch.Tensor,
                own_idx: torch.Tensor, temperature: float, top_k: int,
                top_p: float, rep_penalty: float, key_data: torch.Tensor,
                seen_row: torch.Tensor) -> SlotState:
    """Prefill one request's novel suffix (``suffix`` [1, T_bucket], from
    logical position ``start``) into the blocks of ``table_row``, sample
    its first token with the key ``fold_in(key_data, prompt_len)``, and
    install the slot. The dense forward masks key slots past
    ``prompt_len``; masked slots add exactly 0.

    Under the int8 pool ``own_idx`` names only the owned FULL blocks
    (below ``prompt_len // bs``), which are quantized into the pool; the
    partial block ``prompt_len // bs`` seeds the slot's tail slot 0 (slot
    1 zeroed), so a partial block never round-trips through int8."""
    T = suffix.shape[1]
    dev = suffix.device
    bs = state.caches_k[0].shape[1]
    S = table_row.shape[0] * bs
    q_pos = start + torch.arange(T, device=dev)
    cache_pos = torch.arange(S, device=dev)
    mask = ((cache_pos[None, None, :] <= q_pos[None, :, None])
            & (cache_pos[None, None, :] < prompt_len))
    caches, view = _gather_view(state, table_row)
    logits, caches = forward(
        params, suffix, cfg, positions=q_pos[None, :], attn_mask=mask,
        kv_caches=caches, cache_offset=start,
    )
    last = min(max(suffix_len - 1, 0), T - 1)
    flags = RowFlags.of(temperature, top_k, top_p, rep_penalty)

    def row(x, dt):
        return torch.full((1,), x, dtype=dt, device=dev)

    first = sample_rows(
        logits[:, last], row(temperature, torch.float32),
        row(top_k, torch.int32), row(top_p, torch.float32),
        row(rep_penalty, torch.float32), seen_row, key_data[None],
        row(prompt_len, torch.int64), flags,
    )[0]
    record_seen(seen_row, first[None], flags.penalty)
    if view is None:
        _put_owned(state, caches, table_row, own_idx)
    else:
        _put_quantized(state, view, table_row, own_idx)
        # the partial block (clipped: prompt_len // bs == M only for a row
        # that fills its table and never decodes) and zeroed spill room
        _seed_tail(state, view, min(prompt_len // bs, table_row.shape[0] - 1),
                   slot)
    # the slot's row of every field, in place
    state.tables[slot] = table_row
    state.last_token[slot] = first
    state.offset[slot] = prompt_len
    state.active[slot] = True
    state.temperature[slot] = temperature
    state.top_k[slot] = top_k
    state.top_p[slot] = top_p
    state.rep_penalty[slot] = rep_penalty
    state.seen[slot] = seen_row[0]
    state.rng[slot] = key_data
    return state


def _admit_draft(dparams: Params, dstate: DraftState, window: torch.Tensor,
                 prompt_len: int, dcfg: ModelConfig, slot: int) -> DraftState:
    """Prefill the DRAFT model over one slot's full effective prompt
    (``window`` [1, T_bucket], padded) and install the row, IN PLACE: the
    forward runs against throwaway 1-row caches (dense attention) whose
    KV lands in the slot's stripe of the draft's caches, and ``prev`` is
    the prompt's last token. Padded positions carry junk KV that the
    verify window's repair forward and propose steps rewrite before any
    read. A 0-layer (bigram) draft has no KV: only ``prev`` is set."""
    if dcfg.num_hidden_layers > 0:
        T = window.shape[1]
        dev = window.device
        n_kv, D = dstate.caches_k[0].shape[2:]
        dt = dstate.caches_k[0].dtype
        caches = [(torch.zeros((1, T, n_kv, D), dtype=dt, device=dev),
                   torch.zeros((1, T, n_kv, D), dtype=dt, device=dev))
                  for _ in range(dcfg.num_hidden_layers)]
        pos = torch.arange(T, device=dev)
        mask = pos[None, None, :] <= pos[None, :, None]
        _, caches = forward(dparams, window, dcfg, attn_mask=mask,
                            kv_caches=caches, cache_offset=0,
                            return_hidden=True)
        for ck, cv, (vk, vv) in zip(dstate.caches_k, dstate.caches_v,
                                    caches):
            ck[slot, :T] = vk[0]  # in place
            cv[slot, :T] = vv[0]  # in place
    dstate.prev[slot] = window[0, prompt_len - 1]
    return dstate


def _prefill_chunk(params: Params, state: SlotState, window: torch.Tensor,
                   pos: int, cfg: ModelConfig, table_row: torch.Tensor,
                   own_idx: torch.Tensor) -> SlotState:
    """Commit ONE fixed-size prefill chunk's KV (``window`` [1, C] at
    logical position ``pos``) into the owned blocks of ``table_row``: no
    sampling, and the slot stays inactive with an all-null table until
    ``_admit_slot`` finishes the tail. The window lies inside the prompt,
    so the plain causal mask over logical positions is the admit's.
    Under the int8 pool every owned block is quantized, as the reference
    does (blocks past the chunk carry junk that later dispatches
    rewrite)."""
    T = window.shape[1]
    dev = window.device
    bs = state.caches_k[0].shape[1]
    S = table_row.shape[0] * bs
    q_pos = pos + torch.arange(T, device=dev)
    mask = torch.arange(S, device=dev)[None, None, :] <= q_pos[None, :, None]
    caches, view = _gather_view(state, table_row)
    _, caches = forward(
        params, window, cfg, positions=q_pos[None, :], attn_mask=mask,
        kv_caches=caches, cache_offset=pos, return_hidden=True,
    )
    if view is None:
        _put_owned(state, caches, table_row, own_idx)
    else:
        _put_quantized(state, view, table_row, own_idx)
    return state


class EngineDrainingError(RuntimeError):
    """submit() refused because the engine is draining: the request is
    valid, this replica just will not take it (the server answers 503
    ``draining``, with no Retry-After: a drained replica does not
    recover for new work)."""


class EngineOverloadedError(RuntimeError):
    """submit() shed because the waiting work (queue, holdover, parked
    rows) reached ``queue_depth_limit``: the server answers 503
    ``overloaded`` with ``Retry-After``. ``request`` is the refused
    request, completed with ``failed == "shed"``."""

    def __init__(self, msg: str, retry_after_s: float = 1.0,
                 request=None) -> None:
        super().__init__(msg)
        self.retry_after_s = retry_after_s
        self.request = request


@dataclass(frozen=True)
class PreemptionPolicy:
    """SLO-aware preemption knobs. A waiter triggers a park only when ALL
    of: its wait exceeds ``threshold_s``, the engine's private queue_wait
    SLO burn rate has reached ``burn_limit`` (burn 1.0 = spending error
    budget exactly at the sustainable rate), at least ``cooldown_steps``
    decode steps ran since the last park, and some victim has decoded at
    least ``min_progress`` tokens since its own (re)admission. The last
    two are the anti-livelock levers: every park is preceded by forward
    progress, so an oversubscribed engine round-robins rather than
    thrashes."""

    threshold_s: float = 0.5
    objective: float = 0.9  # good fraction target for the private SLO
    burn_limit: float = 1.0
    cooldown_steps: int = 4
    min_progress: int = 2

    @classmethod
    def parse(cls, spec: str) -> "PreemptionPolicy":
        """``THRESHOLD_S[:BURN_LIMIT]``, the --preemption-slo syntax, e.g.
        ``0.5`` or ``0.5:2.0``."""
        parts = spec.split(":")
        if len(parts) > 2:
            raise ValueError(
                f"preemption spec {spec!r} is not THRESHOLD_S[:BURN_LIMIT]")
        kw: dict = {"threshold_s": float(parts[0])}
        if len(parts) == 2:
            kw["burn_limit"] = float(parts[1])
        return cls(**kw)


# process-wide request ids, as the reference's
_REQ_IDS = itertools.count()


@dataclass
class _Request:
    prompt: list[int]
    max_new: int
    eos_id: int
    rid: int = field(default_factory=lambda: next(_REQ_IDS))
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    rep_penalty: float = 1.0
    seed: int = 0
    out_tokens: list[int] = field(default_factory=list)
    # verify-window accounting: accepted draft tokens and windows that
    # rolled at least one draft back
    spec_accepted: int = 0
    spec_rollbacks: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    cancelled: threading.Event = field(default_factory=threading.Event)
    # set instead of a normal completion when the engine shut down
    # mid-flight (or shed the request at the door): truncated output
    # must not look like success
    failed: str = ""
    # request timeline (``tracing.now()`` seconds), written by the
    # scheduler and read after ``done`` is set
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: float = 0.0
    t_done: float = 0.0
    token_times: list[float] = field(default_factory=list)
    # True once a token time was interpolated inside a fused window (one
    # clock read a window): engine.decode carries kubeinfer.interpolated
    interpolated: bool = False
    # the submitter's trace context (the scheduler thread has none): the
    # parent of the request's engine.* spans
    trace_parent: "tracing.SpanContext | None" = None
    # preemption: t_parked restarts the request's place in the
    # longest-pending-first order (a just-parked victim goes to the back
    # of the line); tokens_at_admit anchors the min_progress guard to the
    # current residency
    t_parked: float = 0.0
    preemptions: int = 0
    tokens_at_admit: int = 0
    # disaggregated prefill: export_kv asks the scheduler to capture this
    # request's committed full-block pages at finalize time; kv_export is
    # the captured dict (pages_k/pages_v/fingerprints/block_size/kv_dtype,
    # scales under the int8 pool), read after ``done`` is set
    export_kv: bool = False
    kv_export: dict | None = None
    # live-session migration: set INSTEAD of a normal completion when a
    # drain handed the session off (the tokens so far, a prefix of the
    # final answer, and the committed blocks streamed), read after
    # ``done`` is set
    migrated: dict | None = None

    @property
    def pending_since(self) -> float:
        return self.t_parked or self.t_submit

    def cancel(self) -> None:
        """Abandon the request: dropped before admission or retired at
        the next step."""
        self.cancelled.set()


@dataclass
class _PrefillTask:
    """One in-progress chunked prefill: the slot is reserved (its
    ``_slot_req`` entry set, blocks held) but the row stays inactive.
    ``pos`` is the next logical position to prefill."""

    req: _Request
    slot: int
    table_row: np.ndarray  # i32[max_blocks]
    own_mask: np.ndarray  # bool[max_blocks]
    reuse: int  # radix-matched full blocks
    total: int  # blocks held by the slot (prompt + decode horizon)
    pos: int
    # the EFFECTIVE prompt: the prompt + any tokens generated before a
    # park (or handed over by a resume)
    tokens: list[int]
    resumed: bool = False
    # the plan reserved verify slack, so the finalize also prefills the
    # slot's draft row
    spec_ok: bool = False


@dataclass
class _ImportTask:
    """One staged KV import: an HTTP thread fetched and verified the
    pages (``disagg.client``), the scheduler thread writes them into the
    pool (it is the only writer of the device state). ``tokens`` covers
    exactly the imported full blocks (n * block_size tokens, through the
    chunk's end for a chunked import); ``pages_k``/``pages_v`` are CPU
    tensors ``[L, n, bs, n_kv, D]``, the scales ``[L, n, n_kv]`` f32 on
    the int8 wire."""

    tokens: list[int]
    pages_k: torch.Tensor
    pages_v: torch.Tensor
    scales_k: torch.Tensor | None = None
    scales_v: torch.Tensor | None = None
    # chunked import (wire v3): the pages cover blocks [start_block,
    # start_block + n) and stack on a radix-matched [0, start_block)
    start_block: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    imported: int = 0
    reason: str | None = None


def _land_pages(state: SlotState, idx: torch.Tensor, pk, pv, sk, sv) -> None:
    """Write imported pages ``[L, n, bs, n_kv, D]`` (and the int8 pool's
    scales ``[L, n, n_kv]``) on the pool's device into the pool blocks
    ``idx``, IN PLACE."""
    if state.quantized:
        state.q8_pages[0][:, idx] = pk  # in place; the views follow
        state.q8_pages[1][:, idx] = pv
        state.q8_scales[0][:, idx] = sk
        state.q8_scales[1][:, idx] = sv
    else:
        for l in range(len(state.caches_k)):
            state.caches_k[l][idx] = pk[l]  # in place
            state.caches_v[l][idx] = pv[l]


def _pages_of(state: SlotState, idx: torch.Tensor) -> dict:
    """The pool blocks ``idx`` on the host (see ``_gather_pages``)."""
    if state.quantized:
        pages = state.q8_pages[:, :, idx].cpu()
        scales = state.q8_scales[:, :, idx].cpu()
        return {"pages_k": pages[0], "pages_v": pages[1],
                "scales_k": scales[0], "scales_v": scales[1]}
    return {
        "pages_k": torch.stack([ck[idx] for ck in state.caches_k]).cpu(),
        "pages_v": torch.stack([cv[idx] for cv in state.caches_v]).cpu(),
    }


class ContinuousEngine:
    """Slot-scheduled generation on one device (``device=None``: the CUDA
    card, raising when there is none), or on the tp ranks of ``layout``:
    ``submit()`` from any thread; a single scheduler thread admits
    requests into free slots and steps the shared decode batch."""

    def __init__(self, params: Params, cfg: ModelConfig,
                 n_slots: int = 8, cache_len: int = 1024,
                 speculative=None, block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefill_chunk_blocks: int = 0,
                 preemption=None,
                 max_window: int = 8,
                 layout=None,
                 spec_draft=None,
                 spec_k: int = 4,
                 kv_dtype: str = "bf16",
                 weight_dtype: str = "bf16",
                 queue_depth_limit: int = 0,
                 migration_chunk_blocks: int = 4,
                 flight_capacity: int = 512,
                 replica_name: str | None = None,
                 device=None) -> None:
        # the device layout (sharding.EngineLayout): tp=1 (the default) is
        # meshless, and every placement below is the single-device one
        if layout is None:
            layout = EngineLayout()
        elif not isinstance(layout, EngineLayout):
            raise TypeError(f"layout must be a sharding.EngineLayout, got "
                            f"{type(layout).__name__}")
        self.layout = layout
        layout.check_model(cfg)
        if isinstance(params, ShardedParams) and not layout.sharded:
            raise ValueError("sharded params need the EngineLayout of their "
                             "mesh")
        for name, value in (("kv_dtype", kv_dtype),
                            ("weight_dtype", weight_dtype)):
            if value not in ("bf16", "int8"):
                raise ValueError(f"{name} must be 'bf16' or 'int8', got "
                                 f"{value!r}")
        # "int8" takes a quantized tree (init_params / params_from_state_
        # dict quantized it layer by layer) or quantizes a plain one here;
        # "bf16" with a quantized tree raises rather than dequantize
        held = params_weight_dtype(params)
        if weight_dtype == "int8" and held == "bf16":
            params = quantize_params(params)
        elif weight_dtype == "bf16" and held == "int8":
            raise ValueError(
                "weight_dtype='bf16' but params are weight-quantized "
                "(dequantize_params first, or pass weight_dtype='int8')")
        self.weight_dtype = weight_dtype
        if layout.sharded:
            # the first tp rank's device holds the replicated state
            first = layout.devices[0]
            if device is not None and not same_device(resolve_device(device),
                                                      first):
                raise ValueError(f"layout's first rank is on {first}, "
                                 f"engine asked for {device}")
            self.device = first
            self.params = layout.shard_params(params, cfg)
        else:
            self.device = resolve_device(device)
            self.params = params_to(params, self.device)
        self.model_param_bytes = param_bytes(self.params)
        self.cfg = cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.block_size = block_size if block_size is not None else min(
            DEFAULT_BLOCK_SIZE, cache_len)
        if cache_len % self.block_size:
            raise ValueError(
                f"cache_len {cache_len} must be a multiple of block_size "
                f"{self.block_size}")
        self.max_blocks = cache_len // self.block_size
        if num_blocks is None:
            # 2x slot capacity (+ the null block): the surplus is what the
            # radix cache retains between requests
            num_blocks = 1 + 2 * n_slots * self.max_blocks
        if num_blocks < 1 + n_slots * self.max_blocks:
            raise ValueError(
                f"num_blocks {num_blocks} < 1 + n_slots * max_blocks "
                f"({1 + n_slots * self.max_blocks}): a request could "
                "never admit")
        self._pool = BlockPool(num_blocks, self.block_size)
        self._radix = RadixCache(self._pool)
        if prefill_chunk_blocks < 0:
            raise ValueError(f"prefill_chunk_blocks must be >= 0, got "
                             f"{prefill_chunk_blocks}")
        self.chunk_tokens = prefill_chunk_blocks * self.block_size
        if max_window < 1:
            raise ValueError(f"max_window must be >= 1, got {max_window}")
        self.max_window = max_window
        self._window_buckets = tuple(b for b in WINDOW_BUCKETS
                                     if b <= max_window)
        self.chunks_total = 0  # telemetry: intermediate chunk dispatches
        self.windows_total = 0  # telemetry: decode and verify dispatches
        # staged KV imports: appended by HTTP threads under _lock, serviced
        # one per scheduler pass by _step_import, swept by _fail_inflight
        self._imports: list[_ImportTask] = []
        self.imports_total = 0  # telemetry: serviced KV imports
        self.imported_blocks_total = 0  # telemetry: blocks written in
        # admissions planned while a decode window is in flight
        # (host-side radix match + block alloc only), admitted at the
        # next window boundary
        self._staged: list[tuple[_Request, int, tuple, list[int]]] = []
        # SLO-aware preemption: a PRIVATE monitor (one queue_wait
        # objective), fed at first admits and by the live head-wait probe
        # of _maybe_preempt, so a wedged engine still sees its burn rise
        self.preemption = preemption
        self._slo: SLOMonitor | None = None
        if preemption is not None:
            self._slo = SLOMonitor(
                objectives=(SLOObjective("queue_wait", preemption.threshold_s,
                                         preemption.objective),),
                windows=(30.0, 300.0), name="batching.SLOMonitor._lock")
        self._prefills: list[_PrefillTask] = []
        # preempted requests awaiting readmit
        self._parked: list[_Request] = []
        # cooldown ticks on decode steps; starts past the gate so the
        # first pressure spike can preempt at once
        self._steps_since_preempt = 1 << 30
        self.preempted_total = 0  # telemetry: rows parked
        self.resumed_total = 0  # telemetry: parked rows readmitted
        # live-session migration: while _draining, submit() refuses,
        # pending requests complete as migrated, and live slots stream
        # their committed blocks through migration_sink one chunk per
        # scheduler pass, then park-for-migrate. _draining is read
        # locklessly on the hot paths (a racing submit lands in the
        # queue and the next drain sweep migrates it)
        if migration_chunk_blocks < 1:
            raise ValueError(f"migration_chunk_blocks must be >= 1, got "
                             f"{migration_chunk_blocks}")
        self.migration_chunk_blocks = migration_chunk_blocks
        self._draining = False
        self._drained = threading.Event()
        # set by the serving layer: called on the scheduler thread, off
        # the lock, with one chunk dict (start_block, pages, fingerprints,
        # scales under the int8 pool)
        self.migration_sink = None
        # per slot: committed blocks already streamed out
        self._migrate_cursor: dict[int, int] = {}
        self.migrated_total = 0  # telemetry: sessions handed off
        self.migration_chunks_total = 0  # telemetry: chunks streamed
        self.migration_blocks_total = 0  # telemetry: blocks streamed
        # load shedding: 0 = unbounded; > 0 sheds submits once the
        # waiting work (queue + holdover + parked) reaches the limit
        self.queue_depth_limit = int(queue_depth_limit)
        self._holdover: "collections.deque[_Request]" = collections.deque()
        # one record per device dispatch, and the ring of scheduler
        # decisions. The kv_stats callback reads the pool's host counters
        # OUTSIDE the profiler lock (engine -> radix -> pool order)
        self.profiler = StepProfiler(
            n_slots=n_slots,
            kv_stats=lambda: (self._pool.used_blocks,
                              self._pool.free_blocks),
            name="batching.StepProfiler._lock")
        if flight_capacity < 1:
            raise ValueError(
                f"flight_capacity must be >= 1, got {flight_capacity}")
        self.flight = FlightRecorder(capacity=flight_capacity,
                                     name="batching.FlightRecorder._lock")
        # the replica attr of this engine's spans (None adds none); the
        # server names an unnamed engine after its model id
        self.replica_name = replica_name
        self._slot_blocks: list[list[int]] = [[] for _ in range(n_slots)]
        # the host's copy of each slot's sampling settings (the device
        # keeps them in the SlotState): the sampling gates branch on it
        self._slot_cfg = {
            "temperature": np.zeros(n_slots, np.float32),
            "top_k": np.zeros(n_slots, np.int32),
            "top_p": np.ones(n_slots, np.float32),
            "rep_penalty": np.ones(n_slots, np.float32),
        }
        # the draft-GROUP route: eligible requests decode through an
        # incremental SpeculativeEngine group beside the slots (one live
        # group at a time), unless a draft rides the batch itself
        self.speculative = speculative
        self.spec_served = 0  # telemetry: requests served via the draft
        self.spec_accepted = 0  # telemetry: accepted draft tokens, groups
        # (member requests, live group handle)
        self._spec_group = None
        # the VERIFY route: spec_k proposals per live row, one fused
        # verify_window per pass while every decoding row is spec-capable
        self.spec_draft = spec_draft
        self.spec_k = spec_k
        self._dparams: Params | None = None
        self._dcfg: ModelConfig | None = None
        self._dstate: DraftState | None = None
        # per slot: verify slack reserved AND the draft row prefilled
        self._slot_spec_ok = [False] * n_slots
        # verify-path counters: proposed draft tokens, host-accepted draft
        # tokens, windows that rolled at least one draft back
        self.spec_draft_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rollbacks = 0
        if spec_draft is not None:
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
            dparams, dcfg = spec_draft
            if dcfg.vocab_size != cfg.vocab_size:
                raise ValueError(
                    "draft/target vocabulary mismatch: "
                    f"{dcfg.vocab_size} vs {cfg.vocab_size}")
            if spec_k + 1 > cache_len:
                raise ValueError(f"spec_k {spec_k} leaves no room in "
                                 f"cache_len {cache_len}")
            if isinstance(dparams, ShardedParams):
                # the draft replicates under tp, as in the reference: one
                # plain copy on the first rank's device
                dparams = unshard_params(dparams)
            self._dparams = params_to(dparams, self.device)
            self._dcfg = dcfg
            self._dstate = init_draft_state(
                dcfg, n_slots, cache_len, params_dtype(self.params),
                self.device)
        self.kv_dtype = kv_dtype
        # int8 pool telemetry: logical blocks quantize-committed into the
        # pool (the admit's full blocks and the decode windows' tail
        # commits), counted on the host as the reference counts them
        self.quant_blocks_total = 0
        self._state = layout.shard_state(init_slot_state(
            cfg, n_slots, cache_len, params_dtype(self.params), num_blocks,
            self.block_size, kv_dtype=kv_dtype, device=self.device))
        st = self._state
        # pages, plus scales and tails under the int8 pool, summed over the
        # tp ranks
        self.kv_pool_bytes = param_bytes([
            *st.caches_k, *st.caches_v, *st.scales_k, *st.scales_v,
            *st.tails_k, *st.tails_v])
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slot_req: list[_Request | None] = [None] * n_slots
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # guards _slot_req and request results between the scheduler loop
        # and stop()'s cleanup
        self._lock = threading.Lock()

    # -- public API -------------------------------------------------------

    def fits(self, prompt_len: int, max_new_tokens: int) -> bool:
        """Can this request ride a slot? (callers fall back to the
        per-request engine when not)"""
        return (
            prompt_len > 0
            and prompt_len + max_new_tokens <= self.cache_len
            and _bucket(prompt_len) <= self.cache_len
        )

    def submit(self, prompt: list[int], max_new_tokens: int = 32,
               eos_id: int = -1, temperature: float = 0.0,
               seed: int = 0, top_k: int = 0, top_p: float = 1.0,
               repetition_penalty: float = 1.0,
               export_kv: bool = False,
               resume_tokens: list[int] | None = None) -> _Request:
        """Queue a request; ``export_kv`` captures its committed full
        prompt blocks after the admit (``req.kv_export``), and with
        ``max_new_tokens=0`` the request retires right there, nothing
        generated (the prefill replica's role).

        ``resume_tokens`` (migration resume): the tokens a source replica
        already generated. They pre-populate ``out_tokens``, so the admit
        takes the readmit route (effective prompt = prompt +
        resume_tokens, remaining budget = max_new - len(resume_tokens))
        and every later sample draws the noise an uninterrupted run would
        at that position. ``max_new_tokens`` stays the original total
        budget; the returned ``out_tokens`` starts with resume_tokens."""
        if self._draining:
            # lockless: a submit racing the flag lands in the queue and
            # the next drain sweep migrates it
            raise EngineDrainingError("engine is draining")
        if not prompt:
            raise ValueError("empty prompt")
        if not self.fits(len(prompt), max_new_tokens):
            raise ValueError(
                f"request (prompt {len(prompt)} + new {max_new_tokens}, "
                f"prefill bucket {_bucket(len(prompt))}) exceeds slot "
                f"capacity ({self.cache_len})")
        rt = [int(t) for t in (resume_tokens or [])]
        if rt:
            if len(rt) >= max_new_tokens:
                raise ValueError(f"resume_tokens ({len(rt)}) must leave "
                                 f"budget (max_new {max_new_tokens})")
            if _bucket(len(prompt) + len(rt)) > self.cache_len:
                # the readmit's effective prompt pads to a bucket as a
                # cold admit does
                raise ValueError(
                    f"resume bucket {_bucket(len(prompt) + len(rt))} "
                    f"exceeds slot capacity ({self.cache_len})")
        if self.queue_depth_limit:
            # lockless depth read (torn by at most 1); >= so a limit of 1
            # sheds whenever anything is already waiting
            depth = (self._queue.qsize() + len(self._holdover)
                     + len(self._parked))
            if depth >= self.queue_depth_limit:
                # ledgered as submit -> backpressure -> fail, so a flight
                # post-mortem sees why the request never reached a slot
                req = _Request(list(prompt), max_new_tokens, eos_id,
                               temperature=temperature, top_k=top_k,
                               top_p=top_p, rep_penalty=repetition_penalty,
                               seed=seed)
                req.t_submit = tracing.now()
                req.failed = "shed"
                self._note("submit", req=req.rid, prompt_tokens=len(prompt),
                           max_new=max_new_tokens)
                self._note("backpressure", req=req.rid,
                           reason="queue_depth_limit", depth=depth,
                           limit=self.queue_depth_limit)
                self._note("fail", req=req.rid, reason="shed")
                req.done.set()
                raise EngineOverloadedError(
                    f"queue depth {depth} >= queue_depth_limit "
                    f"{self.queue_depth_limit}", request=req)
        req = _Request(list(prompt), max_new_tokens, eos_id,
                       temperature=temperature, top_k=top_k, top_p=top_p,
                       rep_penalty=repetition_penalty, seed=seed,
                       export_kv=export_kv)
        if rt:
            # a non-empty out_tokens is how the admit tells a resume (as
            # it tells a parked readmit); these were timed at the source
            req.out_tokens = rt
        # the submitter's context, captured here: the scheduler thread's
        # span stack is empty
        ctx = tracing.current_context()
        req.trace_parent = ctx if ctx is not None else \
            tracing.new_root_context()
        req.t_submit = tracing.now()
        # noted BEFORE the publish: once queued the scheduler may admit
        # it, and its admit must not precede its submit in the ring
        self._note("submit", req=req.rid, prompt_tokens=len(prompt),
                   max_new=max_new_tokens)
        self._queue.put(req)
        return req

    def serve(self, prompt: list[int], max_new_tokens: int = 32,
              eos_id: int = -1, temperature: float = 0.0,
              seed: int = 0, top_k: int = 0, top_p: float = 1.0,
              repetition_penalty: float = 1.0,
              timeout: float = 300.0,
              export_kv: bool = False,
              resume_tokens: list[int] | None = None) -> _Request:
        """submit() + wait; returns the completed request (tokens and
        timeline). A request that completes by MIGRATION returns normally
        with ``req.migrated`` set."""
        req = self.submit(prompt, max_new_tokens, eos_id,
                          temperature=temperature, seed=seed, top_k=top_k,
                          top_p=top_p, repetition_penalty=repetition_penalty,
                          export_kv=export_kv, resume_tokens=resume_tokens)
        if not req.done.wait(timeout):
            req.cancel()
            raise TimeoutError("generation timed out")
        if req.failed:
            raise RuntimeError(req.failed)
        return req

    def generate(self, prompt: list[int], max_new_tokens: int = 32,
                 eos_id: int = -1, temperature: float = 0.0,
                 seed: int = 0, top_k: int = 0, top_p: float = 1.0,
                 repetition_penalty: float = 1.0,
                 timeout: float = 300.0) -> list[int]:
        return self.serve(
            prompt, max_new_tokens, eos_id, temperature=temperature,
            seed=seed, top_k=top_k, top_p=top_p,
            repetition_penalty=repetition_penalty, timeout=timeout,
        ).out_tokens

    @property
    def draining(self) -> bool:
        return self._draining

    def drain(self) -> None:
        """Flip the engine into drain mode: submit() refuses, and the
        scheduler replaces admission and preemption with ``_step_drain``
        (pending requests complete as migrated, live slots stream their
        committed KV through ``migration_sink`` one chunk per pass with
        decode windows between, then park-for-migrate). Idempotent;
        ``undrain()`` reverses it."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drained.clear()
            # under the lock: drain_start precedes every migrate* event
            self._note("drain_start")

    def undrain(self) -> None:
        """Resume admissions after a drain. Sessions already migrated are
        gone: a bounced-back one re-enters through
        ``submit(resume_tokens=...)`` and lands warm on the blocks
        ``_migrate_slot`` left in the trie."""
        with self._lock:
            if not self._draining:
                return
            self._draining = False
            self._drained.clear()
            self._note("drain_end")

    def wait_drained(self, timeout_s: float = 30.0) -> bool:
        """Block until every live session reached a terminal state (done,
        failed, cancelled or migrated) and the queue is empty. Only
        meaningful while draining."""
        return self._drained.wait(timeout_s)

    def import_prefix(self, tokens: list[int], pages_k, pages_v,
                      timeout_s: float = 10.0, scales_k=None, scales_v=None,
                      kv_dtype: str = "bf16",
                      start_block: int = 0) -> tuple[int, str | None]:
        """Land a remotely prefilled prefix in the local pool + radix
        cache. Callable from any thread: the write is staged for the
        scheduler thread and this call waits for it. Returns
        ``(blocks_imported, reason)``; reason is None on success, else a
        low-cardinality fallback label. Never raises: a failure here only
        means the request prefills locally (token-identical).

        ``tokens`` must cover exactly the imported full blocks and
        ``pages_k``/``pages_v`` be ``[L, n, block_size, n_kv, D]`` CPU
        tensors in the pool's dtype (as ``disagg.wire.decode_payload``
        gives them). ``start_block`` supports chunked imports (wire v3):
        the pages cover blocks ``[start_block, start_block + n)`` of
        ``tokens`` and the first ``start_block`` blocks must already be in
        the radix cache, else ``missing_prefix``."""
        if start_block < 0:
            return 0, "shape_mismatch"
        if kv_dtype != self.kv_dtype:
            # an int8 page without its scales, or bf16 pages an int8 pool
            # would have to requantize blind: rejected before staging
            return 0, "kv_dtype_mismatch"
        if pages_k.ndim != 5 or pages_k.shape != pages_v.shape:
            return 0, "shape_mismatch"
        n = int(pages_k.shape[1])
        if n == 0 or start_block + n > self.max_blocks or \
                len(tokens) != (start_block + n) * self.block_size:
            return 0, "shape_mismatch"
        if kv_dtype == "int8":
            want_s = (pages_k.shape[0], n, pages_k.shape[3])
            if (scales_k is None or scales_v is None
                    or tuple(scales_k.shape) != want_s
                    or tuple(scales_v.shape) != want_s):
                return 0, "shape_mismatch"
        if self._stop.is_set() or self._thread is None:
            return 0, "stopped"
        task = _ImportTask(list(tokens), pages_k, pages_v, scales_k=scales_k,
                           scales_v=scales_v, start_block=start_block)
        with self._lock:
            self._imports.append(task)
        self._note("import_staged", blocks=n)
        if not task.done.wait(timeout_s):
            # the scheduler may still service the task later: that only
            # warms the trie; the caller prefills locally
            return 0, "timeout"
        return task.imported, task.reason

    def _step_import(self) -> None:
        """Service at most ONE staged import per scheduler pass: alloc ->
        write -> trie insert -> drop our alloc hold, leaving the imported
        blocks at trie-only refcount, as a parked prefix (LRU-evictable).
        Spans already cached keep the existing trie nodes and our
        duplicate fresh blocks free right back (dedup by construction).
        The pages cross to the card in one copy per side, in the pool's
        dtype, and are written into the n fresh blocks in place."""
        with self._lock:
            task = self._imports.pop(0) if self._imports else None
        if task is None:
            return
        st = self._state
        n = int(task.pages_k.shape[1])
        L = len(st.caches_k)
        _nb, bs, n_kv, D = st.caches_k[0].shape  # logical under tp
        want = (L, n, bs, n_kv, D)
        pool_dt = st.caches_k[0].dtype
        reason = None
        if task.pages_k.dtype != pool_dt or task.pages_v.dtype != pool_dt:
            # a fleet mixing kv_dtype configurations, which the wire's
            # version negotiation should have caught upstream
            reason = "kv_dtype_mismatch"
        elif tuple(task.pages_k.shape) != want or \
                tuple(task.pages_v.shape) != want:
            reason = "shape_mismatch"
        if reason is not None:
            task.reason = reason
            self._note("import_reject", blocks=n, reason=reason)
            task.done.set()
            return
        start = task.start_block
        with self._lock:
            shared: list[int] = []
            if start:
                # a chunk stacks on the blocks earlier chunks inserted;
                # fewer matches than start_block means the base was
                # evicted between chunks: reject rather than cache a
                # chain with a hole
                matched = self._radix.match(task.tokens[: start * bs])
                if len(matched) < start:
                    if matched:
                        self._pool.unref(matched)
                    task.reason = "missing_prefix"
                    self._note("import_reject", blocks=n,
                               reason=task.reason)
                    task.done.set()
                    return
                shared = matched[:start]
                if len(matched) > start:
                    self._pool.unref(matched[start:])
            if not self._radix.ensure_free(n):
                if shared:
                    self._pool.unref(shared)
                task.reason = "backpressure"
                self._note("import_reject", blocks=n, reason=task.reason)
                task.done.set()
                return
            fresh = self._pool.alloc(n)
        dev = self.device
        idx = torch.tensor(fresh, dtype=torch.long, device=dev)
        sk = sv = None
        if st.quantized:
            sk, sv = task.scales_k.float(), task.scales_v.float()
        with torch.inference_mode():
            if st.sharded:
                # each rank lands its heads' slice of the wire's pages
                pks = st.caches_k[0].split(task.pages_k)
                pvs = st.caches_v[0].split(task.pages_v)
                if st.quantized:
                    sk, sv = st.scales_k[0].split(sk), st.scales_v[0].split(sv)
                for r, rs in enumerate(st.rank_states()):
                    _land_pages(rs, _on(idx, rs), pks[r], pvs[r],
                                None if sk is None else sk[r],
                                None if sv is None else sv[r])
            else:
                _land_pages(st, idx, task.pages_k.to(dev),
                            task.pages_v.to(dev),
                            sk if sk is None else sk.to(dev),
                            sv if sv is None else sv.to(dev))
        with self._lock:
            # the insert covers the WHOLE chain so far (shared base + this
            # chunk); the trie takes its own reference per new node and
            # our holds return here
            created = self._radix.insert(task.tokens, shared + fresh)
            self._pool.unref(shared + fresh)
        self.imports_total += 1
        self.imported_blocks_total += n
        task.imported = n
        self._note("import", blocks=n, created_nodes=created,
                   start_block=start)
        task.done.set()

    def kv_cache_stats(self) -> dict:
        """Pool occupancy plus the radix cache's counters."""
        stats = self._radix.stats()
        stats["blocks_in_use"] = self._pool.used_blocks
        stats["blocks_free"] = self._pool.free_blocks
        stats["pool_bytes"] = self.kv_pool_bytes
        stats["quant_blocks"] = self.quant_blocks_total
        return stats

    def scheduler_stats(self) -> dict:
        """Scheduler counters (lockless reads): parks and readmits and the
        parked rows, prefill chunks, the chunk queue's depth, decode and
        verify dispatches, the draft groups' served requests and accepted
        drafts, the verify route's proposed / accepted draft tokens and
        rollbacks, the serviced KV imports and their blocks, and the
        sessions migrated with the chunks and blocks streamed."""
        return {
            "preempted": self.preempted_total,
            "resumed": self.resumed_total,
            "chunks": self.chunks_total,
            "chunk_queue": len(self._prefills),
            "parked": len(self._parked),
            "windows": self.windows_total,
            "spec_served": self.spec_served,
            "spec_accepted": self.spec_accepted,
            "spec_draft_tokens": self.spec_draft_tokens,
            "spec_accepted_tokens": self.spec_accepted_tokens,
            "spec_rollbacks": self.spec_rollbacks,
            # disaggregated prefill: serviced imports / blocks landed
            "kv_imports": self.imports_total,
            "kv_imported_blocks": self.imported_blocks_total,
            # live-session migration: sessions handed off, chunks and
            # blocks streamed out
            "migrated": self.migrated_total,
            "migration_chunks": self.migration_chunks_total,
            "migration_blocks": self.migration_blocks_total,
        }

    def _span_ids(self, req: _Request) -> dict:
        """The attrs every engine span carries: the request id under the
        flight ring's ``req`` key, and the replica name when set."""
        ids = {"req": req.rid}
        if self.replica_name is not None:
            ids["replica"] = self.replica_name
        return ids

    def _note(self, kind: str, **detail) -> None:
        """A flight-recorder entry with the queue depth and the pool's
        occupancy observed now (host counters under their own locks;
        callable from any thread)."""
        self.flight.note(kind, queue_depth=self._queue.qsize(),
                         kv_in_use=self._pool.used_blocks,
                         kv_free=self._pool.free_blocks, **detail)

    def slo_burn(self) -> float:
        """The worst burn rate over every objective and window of the
        private SLO monitor; 0.0 without one or without traffic."""
        if self._slo is None:
            return 0.0
        worst = 0.0
        for per_window in self._slo.burn_rates().values():
            for rate in per_window.values():
                worst = max(worst, float(rate))
        return worst

    def stats_summary(self, window_s: float = 60.0) -> dict:
        """One dict of plain JSON scalars summarising the replica (the
        node agent's heartbeat, ``/cache/summary``): occupancy, queue
        depth, goodput, pool blocks, prefix hit rate, drain state, burn.
        Lockless reads: a torn read skews queue_depth by one."""
        prof = self.profiler.summary(window_s=window_s)
        kv = self.kv_cache_stats()
        # parked rows count as waiting: they hold no slot
        waiting = len(self._holdover) + len(self._parked)
        lookups = kv["hits"] + kv["misses"]
        return {
            "n_slots": self.n_slots,
            "block_size": self.block_size,
            # the device layout, advertised so a fleet router or a
            # capacity dashboard can tell a tp replica's pool shard from a
            # single-device pool of the same logical block count
            "tp_degree": self.layout.tp,
            "mesh_devices": self.layout.mesh_devices,
            "queue_depth": self._queue.qsize() + waiting,
            "batch_occupancy": round(prof["batch_occupancy"], 6),
            "goodput_tokens_per_sec": round(
                prof["goodput_tokens_per_sec"], 6),
            "padding_waste_frac": round(prof["padding_waste_frac"], 6),
            "kv_blocks_free": kv["blocks_free"],
            "kv_blocks_in_use": kv["blocks_in_use"],
            "kv_dtype": self.kv_dtype,
            "kv_pool_bytes": kv["pool_bytes"],
            "weight_dtype": self.weight_dtype,
            "model_param_bytes": self.model_param_bytes,
            "prefix_hit_rate": round(
                kv["hits"] / lookups if lookups else 0.0, 6),
            "prefix_cached_tokens": kv["cached_tokens"],
            "draining": bool(self._draining),
            "slo_burn": round(self.slo_burn(), 6),
            # capped at kv_blocks.SUMMARY_FINGERPRINT_BUDGET entries
            "cache_summary": self._radix.summary(),
        }

    def prewarm_spec(self, group_sizes: tuple[int, ...] = (1,),
                     prompt_len: int = 8, max_new_tokens: int = 8,
                     sampled: bool = False) -> int:
        """Run ``start_group`` plus one ``step_group`` round per group size
        on dummy prompts before serving, and discard them (the reference
        compiles its group shapes this way; here it warms the allocator
        and the kernel libraries). Returns the number of sizes run; 0
        without a speculative engine."""
        if self.speculative is None:
            return 0
        warmed = 0
        for b in group_sizes:
            b = int(b)
            if b < 1 or not self.speculative.fits(prompt_len,
                                                  max_new_tokens):
                continue
            g = self.speculative.start_group(
                [[1] * prompt_len] * b, max_new_tokens=max_new_tokens,
                temperatures=0.7 if sampled else 0.0)
            self.speculative.step_group(g)
            warmed += 1
        return warmed

    def cache_summary(self) -> dict:
        """Capped radix-summary advertisement for the fleet router."""
        return self._radix.summary()

    def start(self) -> "ContinuousEngine":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="continuous-batcher")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # release every waiter AS FAILURES
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.failed = "engine stopped before the request was served"
            self._note("fail", req=req.rid, reason="engine stopped")
            req.done.set()
        self._fail_inflight()

    def _fail_inflight(self) -> None:
        """Fail every published in-flight request (slots, holdover,
        parked rows, staged plans, chunked prefills); shared by stop() and
        the scheduler loop's epilogue. When it failed any, it logs the
        flight recorder's ring, the scheduler's last decisions."""
        failed = 0
        with self._lock:
            held = list(self._holdover)
            self._holdover.clear()
            parked, self._parked = self._parked, []
            staged, self._staged = self._staged, []
            # staged imports hold no pool references yet (the alloc is in
            # _step_import): releasing their waiters is the whole cleanup
            imports, self._imports = self._imports, []
            self._prefills.clear()
            group, self._spec_group = self._spec_group, None
            for slot, req in enumerate(self._slot_req):
                if req is not None:
                    self._slot_req[slot] = None
                    req.failed = "engine stopped mid-generation"
                    self._note("fail", req=req.rid,
                               reason="stopped mid-generation")
                    req.done.set()
                    failed += 1
        for req in held:
            req.failed = "engine stopped before the request was served"
            self._note("fail", req=req.rid, reason="stopped unserved")
            req.done.set()
            failed += 1
        for req in parked:
            # partial output: a failure, never a truncated completion
            req.failed = "engine stopped mid-generation (stopped while " \
                         "parked)"
            self._note("fail", req=req.rid, reason="stopped while parked")
            req.done.set()
            failed += 1
        for req, _slot, kv_plan, _tokens in staged:
            table_row, _own, _reuse, total, _spec = kv_plan
            self._pool.unref([int(b) for b in table_row[:total]])
            req.failed = "engine stopped before the request was served"
            self._note("fail", req=req.rid, reason="stopped while staged")
            req.done.set()
            failed += 1
        for task in imports:
            task.reason = "stopped"
            task.done.set()
        if group is not None:
            for req in group[0]:
                req.failed = "engine stopped mid-generation"
                self._note("fail", req=req.rid,
                           reason="stopped mid spec-group")
                req.done.set()
                failed += 1
        if failed:
            # stop() and the loop's epilogue both sweep: only the one
            # that found requests dumps
            self._note("fail_inflight", failed=failed)
            log.warning("engine stopped with %d in-flight request(s); "
                        "flight recorder dump:\n%s", failed,
                        self.flight.render())

    # -- scheduler --------------------------------------------------------

    def _plan_kv(self, tokens: list[int], max_new: int, rid: int = -1):
        """Host-side paged-admit plan: radix match -> capacity clamp ->
        evict/alloc. Returns ``(table_row, own_mask, reuse, total,
        spec_ok)`` or None when the pool cannot supply the fresh blocks.
        On success the slot holds one reference per block in
        ``table_row[:total]``.

        Verify slack: a verify window writes KV up to ``offset + spec_k``,
        so a spec-capable slot holds ceil((p + max_new + spec_k) / bs)
        blocks. Under pool pressure the plan drops the slack first
        (``spec_ok=False``: the batch then decodes through decode_window
        while the row lives)."""
        p = len(tokens)
        bs = self.block_size
        matched = self._radix.match(tokens)  # +1 ref each, ours now
        # full blocks only, and never the whole prompt: the last token is
        # recomputed so the admit has logits to sample from
        reuse = min(len(matched), (p - 1) // bs)
        # the suffix pads to a bucket that must fit the logical row
        while reuse > 0 and reuse * bs + _bucket(p - reuse * bs) > \
                self.cache_len:
            reuse -= 1
        if reuse < len(matched):
            self._pool.unref(matched[reuse:])
        shared = matched[:reuse]
        plain = -(-(p + max_new) // bs)
        spec_ok = (self.spec_draft is not None
                   and p + max_new + self.spec_k <= self.cache_len)
        total = -(-(p + max_new + self.spec_k) // bs) if spec_ok else plain
        ev_before = self._radix.stats()["evictions"]
        if not self._radix.ensure_free(total - reuse):
            if spec_ok and total > plain and \
                    self._radix.ensure_free(plain - reuse):
                total, spec_ok = plain, False
            else:
                if shared:
                    self._pool.unref(shared)
                self._note("backpressure", req=rid, prompt_tokens=p,
                           need_blocks=total - reuse,
                           free_blocks=self._pool.free_blocks,
                           evictable_blocks=self._radix.evictable_blocks(),
                           reason="pool pinned beyond eviction reach")
                return None
        evicted = self._radix.stats()["evictions"] - ev_before
        if evicted:
            self._note("evict", nodes=evicted, need_blocks=total - reuse)
        fresh = self._pool.alloc(total - reuse)
        self._radix.note_result(reuse)
        table_row = np.zeros(self.max_blocks, np.int32)
        table_row[:reuse] = shared
        table_row[reuse:total] = fresh
        own_mask = np.zeros(self.max_blocks, bool)
        own_mask[reuse:total] = True
        return table_row, own_mask, reuse, total, spec_ok

    def _admit(self, slot: int, req: _Request, kv_plan,
               tokens: list[int]) -> None:
        """Reserve ``slot`` for ``req`` and start its prefill: a chunked
        task when chunking applies, else the whole suffix at once."""
        table_row, own_mask, reuse, total, spec_ok = kv_plan
        resumed = bool(req.out_tokens)
        if not resumed:
            # first admission only: a readmit is not a queue exit
            req.t_admit = tracing.now()
            _TRACER.record_span(
                "engine.queue_wait", start=req.t_submit, end=req.t_admit,
                parent=req.trace_parent, slot=slot, **self._span_ids(req))
            if self._slo is not None:
                self._slo.observe("queue_wait", req.t_admit - req.t_submit,
                                  t=req.t_admit)
        self._slot_req[slot] = req
        self._slot_blocks[slot] = [int(b) for b in table_row[:total]]
        # flips True only once the finalize committed the draft row too
        self._slot_spec_ok[slot] = False
        req.tokens_at_admit = len(req.out_tokens)
        task = _PrefillTask(
            req=req, slot=slot, table_row=table_row, own_mask=own_mask,
            reuse=reuse, total=total, pos=reuse * self.block_size,
            tokens=tokens, resumed=resumed, spec_ok=spec_ok,
        )
        if self._next_chunk_len(task) is not None:
            self._prefills.append(task)
            return
        self._finalize_admit(task)

    def _next_chunk_len(self, task: _PrefillTask) -> int | None:
        """Chunk width for ``task``'s next dispatch, or None when the
        remaining suffix should finalize through ``_admit_slot``."""
        C = self.chunk_tokens
        if not C:
            return None
        rem = len(task.tokens) - task.pos
        if rem <= C:
            return None
        if task.pos + C + _bucket(rem - C) > self.cache_len:
            return None
        return C

    def _row_operands(self, task: _PrefillTask, below: int | None = None):
        """The task's table row and the indices of the owned blocks it
        writes back, on the device; with ``below``, only those under it
        (an int8 admit quantizes its full prompt blocks only)."""
        dev = self.device
        table_row = torch.from_numpy(task.table_row).to(dev).long()
        own = task.own_mask
        if below is not None:
            own = own & (np.arange(self.max_blocks) < below)
        return table_row, torch.from_numpy(np.nonzero(own)[0]).to(dev)

    def _step_prefill(self) -> None:
        """Advance the oldest chunked prefill by at most one dispatch."""
        with self._lock:
            task = self._prefills[0] if self._prefills else None
        if task is None:
            return
        if task.req.cancelled.is_set():
            with self._lock:
                if self._prefills and self._prefills[0] is task:
                    self._prefills.pop(0)
                    self._abort_prefill(task)
            return
        C = self._next_chunk_len(task)
        if C is None:
            with self._lock:
                if not self._prefills or self._prefills[0] is not task:
                    return  # stop() cleared the queue mid-pass
                self._prefills.pop(0)
                self._finalize_admit(task)
            return
        window = torch.tensor([task.tokens[task.pos:task.pos + C]],
                              dtype=torch.int64, device=self.device)
        table_row, own_idx = self._row_operands(task)
        t0 = tracing.now()
        with torch.inference_mode():
            self._state = _prefill_chunk(self.params, self._state, window,
                                         task.pos, self.cfg, table_row,
                                         own_idx)
        task.pos += C
        self.chunks_total += 1
        t1 = tracing.now()
        with self._lock:
            live_rows = sum(1 for r in self._slot_req if r is not None)
        # every chunk token is live prompt work. No readback ends a chunk,
        # so on the card the record times the host's issue of its
        # launches, not the device's work (which the next readback waits)
        self.profiler.record("chunk", bucket=C, live_rows=live_rows,
                             live_tokens=C, padded_tokens=0, start=t0,
                             end=t1)
        self._note("chunk", req=task.req.rid, slot=task.slot, pos=task.pos,
                   prompt_tokens=len(task.tokens))

    def _abort_prefill(self, task: _PrefillTask) -> None:
        """Drop a cancelled mid-chunk prefill (caller holds the lock): the
        row was never activated, so releasing its blocks is the cleanup."""
        slot, req = task.slot, task.req
        self._slot_req[slot] = None
        self._slot_spec_ok[slot] = False
        blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
        if blocks:
            self._pool.unref(blocks)
        req.t_done = tracing.now()
        self._note("retire", req=req.rid, slot=slot,
                   tokens=len(req.out_tokens), freed_blocks=len(blocks),
                   cancelled=True)
        req.done.set()

    def _finalize_admit(self, task: _PrefillTask) -> None:
        """Prefill the remaining suffix, sample the next token, and flip
        the slot live (caller holds the lock). Its profiler record
        brackets the admit's launches and the first token's readback, so
        on the card it times the admit's device work too."""
        req, slot, tokens = task.req, task.slot, task.tokens
        p = len(tokens)
        start = task.pos
        suffix_len = p - start
        t0 = tracing.now()
        T = _bucket(suffix_len)
        padded = np.zeros((1, T), np.int64)
        padded[0, :suffix_len] = tokens[start:]
        dev = self.device
        # the full effective prompt's id set, built on the host: the
        # forward sees only the suffix
        seen_row = np.zeros((1, self.cfg.vocab_size), bool)
        seen_row[0, np.asarray(tokens, np.int64)] = True
        key_data = prng.key_data(prng.key(req.seed, impl="threefry2x32",
                                          device=dev))
        full = p // self.block_size
        table_row, own_idx = self._row_operands(
            task, full if self.kv_dtype == "int8" else None)
        with torch.inference_mode():
            self._state = _admit_slot(
                self.params, self._state, torch.from_numpy(padded).to(dev),
                suffix_len, start, p, self.cfg, slot, table_row, own_idx,
                float(req.temperature), int(req.top_k), float(req.top_p),
                float(req.rep_penalty), key_data,
                torch.from_numpy(seen_row).to(dev),
            )
            if self.spec_draft is not None and task.spec_ok:
                # the draft row's prefill rides the same boundary: no
                # radix reuse and no chunking, the FULL effective prompt
                dwin = np.zeros((1, _bucket(p)), np.int64)
                dwin[0, :p] = tokens
                self._dstate = _admit_draft(
                    self._dparams, self._dstate,
                    torch.from_numpy(dwin).to(dev), p, self._dcfg, slot)
                self._slot_spec_ok[slot] = True
        for name, value in (("temperature", req.temperature),
                            ("top_k", req.top_k), ("top_p", req.top_p),
                            ("rep_penalty", req.rep_penalty)):
            self._slot_cfg[name][slot] = value
        if self.kv_dtype == "int8":
            # every owned full block was quantize-committed above (chunks
            # requantize the same blocks: one logical commit, counted once)
            self.quant_blocks_total += max(0, full - task.reuse)
        # cache the prompt's FULL blocks for later admits, this admit's
        # fresh ones included (the partial tail block stays private)
        if full:
            self._radix.insert(tokens, [int(b) for b in task.table_row[:full]])
        if req.export_kv and full:
            self._capture_export(req, tokens, table_row[:full])
        # admission boundary: the first token reaches the request now; in
        # prefill-only mode (max_new == 0, the export role) it is dropped:
        # the decode replica resamples it from the same distribution
        first = int(self._state.last_token[slot])
        now = tracing.now()
        if req.max_new > 0:
            req.out_tokens.append(first)
            req.token_times.append(now)
        # a readmit keeps its first stamp; a resume from another replica
        # never had one here
        if not req.t_first:
            req.t_first = now
        # the bucket's tail past the suffix is the padding
        live_rows = sum(1 for r in self._slot_req if r is not None)
        self.profiler.record("prefill", bucket=T, live_rows=live_rows,
                             live_tokens=suffix_len,
                             padded_tokens=T - suffix_len, start=t0, end=now)
        if task.resumed:
            self.resumed_total += 1
            self._note("resume", req=req.rid, slot=slot, suffix_bucket=T,
                       reuse_blocks=task.reuse, total_blocks=task.total,
                       preemptions=req.preemptions)
        else:
            self._note("admit", req=req.rid, slot=slot, suffix_bucket=T,
                       reuse_blocks=task.reuse, total_blocks=task.total)
        # a fresh admit's prefill begins where engine.queue_wait ended
        # (chunks included); a readmit's brackets the finalize only
        sp = _TRACER.start_span(
            "engine.prefill", parent=req.trace_parent,
            start=t0 if task.resumed else req.t_admit, slot=slot,
            prompt_tokens=p, bucket=T,
            reused_tokens=task.reuse * self.block_size,
            prefix_hit=task.reuse > 0, **self._span_ids(req))
        sp.event("first-token", ts=now)
        _TRACER.finish(sp, end=now)
        self._maybe_retire(slot)

    def _gather_pages(self, idx: torch.Tensor) -> dict:
        """The committed pages of the pool blocks ``idx`` on the host:
        gathered on the device, one device-to-host copy per side (the
        int8 pool's pages and scales of both sides in one gather each).
        Returns ``pages_k``/``pages_v`` ``[L, n, bs, n_kv, D]``, and
        ``scales_k``/``scales_v`` ``[L, n, n_kv]`` under the int8 pool.
        Under tp each rank's pieces are concatenated along n_kv on the
        host: the wire bytes are tp=1's."""
        st = self._state
        with torch.inference_mode():
            if not st.sharded:
                return _pages_of(st, idx)
            parts = [_pages_of(rs, _on(idx, rs)) for rs in st.rank_states()]
            return {key: torch.cat([p[key] for p in parts],
                                   dim=-2 if key.startswith("pages") else -1)
                    for key in parts[0]}

    def _capture_export(self, req: _Request, tokens: list[int],
                        idx: torch.Tensor) -> None:
        """Capture the committed full-block pages ``idx`` of an admit for
        export (scheduler thread, right after the trie insert). The
        partial tail block never leaves. The fingerprints come out of the
        trie walk, the very chain importers recompute."""
        pages = self._gather_pages(idx)
        pairs = self._radix.match_with_fingerprints(
            tokens[: len(idx) * self.block_size])
        # the walk refs its matches; the slot already holds these blocks
        self._pool.unref([b for b, _ in pairs])
        req.kv_export = {
            **pages,
            "fingerprints": [fp for _, fp in pairs],
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
        }

    def _maybe_retire(self, slot: int) -> None:
        req = self._slot_req[slot]
        if req is None:
            return
        finished = (
            req.cancelled.is_set()
            or len(req.out_tokens) >= req.max_new
            or (req.eos_id >= 0 and req.out_tokens
                and req.out_tokens[-1] == req.eos_id)
        )
        if not finished:
            return
        self._slot_req[slot] = None
        self._slot_spec_ok[slot] = False
        # a drain may have been streaming this slot: a stale cursor would
        # make a later drain stream the wrong blocks
        self._migrate_cursor.pop(slot, None)
        blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
        if blocks:
            # blocks also cached in the trie keep its reference
            self._pool.unref(blocks)
        self._deactivate(slot)
        req.t_done = tracing.now()
        cancelled = req.cancelled.is_set()
        self._note("retire", req=req.rid, slot=slot,
                   tokens=len(req.out_tokens), freed_blocks=len(blocks),
                   cancelled=cancelled)
        sp = _TRACER.start_span(
            "engine.decode", parent=req.trace_parent,
            start=req.t_first or req.t_done, slot=slot,
            tokens=len(req.out_tokens), cancelled=cancelled,
            **self._span_ids(req),
            # token times inside a fused window are interpolated, not
            # measured a step
            **({"kubeinfer.interpolated": True} if req.interpolated
               else {}),
            **({"kubeinfer.spec_accepted": req.spec_accepted,
                "kubeinfer.spec_rollbacks": req.spec_rollbacks}
               if self.spec_draft is not None else {}))
        for i, ts in enumerate(req.token_times[:_MAX_TOKEN_EVENTS]):
            sp.event("token", ts=ts, i=i)
        _TRACER.finish(sp, end=req.t_done)
        req.done.set()

    def _deactivate(self, slot: int) -> None:
        """The row goes inactive and its table all-null, in place, BEFORE
        its next decode write: freed blocks may be re-issued to another
        slot. Runs between windows only (retire, park, migrate)."""
        self._state.active[slot] = False
        self._state.tables[slot] = 0

    # -- preemptive scheduling ----------------------------------------------

    def _release_committed(self, slot: int, req: _Request) -> None:
        """Free ``slot`` of a live decoding row, keeping its committed
        full blocks in the radix trie (the trie's own reference) so a
        readmit or resume matches them warm (caller holds the lock). The
        newest token's KV is not written yet (the next decode step writes
        it at the row's offset), so only blocks fully inside [0, len - 1)
        may enter the trie: a block-aligned park would otherwise cache a
        block whose last position is junk. Under the int8 pool these are
        exactly the blocks the windows quantize-committed; the bf16 tail
        row is dropped and the readmit recomputes it."""
        committed = (req.prompt + req.out_tokens)[:-1]
        full = len(committed) // self.block_size
        blocks, self._slot_blocks[slot] = self._slot_blocks[slot], []
        if full:
            self._radix.insert(committed, blocks[:full])
        self._slot_req[slot] = None
        self._slot_spec_ok[slot] = False
        self._migrate_cursor.pop(slot, None)  # the slot id becomes reusable
        if blocks:
            self._pool.unref(blocks)
        self._deactivate(slot)

    def _park_slot(self, slot: int) -> None:
        """Preempt a decoding row: its committed blocks go into the trie
        at trie-only refcount (LRU-evictable: a parked row never pins the
        pool; an eviction only makes its readmit colder), every slot hold
        is released, and the request joins ``_parked``. Caller holds the
        lock; runs between windows."""
        req = self._slot_req[slot]
        if req is None:
            return
        self._release_committed(slot, req)
        req.t_parked = tracing.now()
        req.preemptions += 1
        self.preempted_total += 1
        self._parked.append(req)
        full = (len(req.prompt) + len(req.out_tokens) - 1) // self.block_size
        self._note("preempt", req=req.rid, slot=slot,
                   tokens=len(req.out_tokens), cached_blocks=full,
                   parked=len(self._parked))

    def _pick_victim(self, pol: PreemptionPolicy) -> int | None:
        """The youngest-arrival decoding slot that has decoded at least
        ``min_progress`` tokens since its own (re)admission and whose cold
        readmit would still fit a slot (caller holds the lock).
        Mid-prefill rows are never parked."""
        prefilling = {t.slot for t in self._prefills}
        victim, victim_t = None, -1.0
        for slot, req in enumerate(self._slot_req):
            if req is None or slot in prefilling:
                continue
            if len(req.out_tokens) - req.tokens_at_admit < \
                    max(1, pol.min_progress):
                continue
            # an evicted park readmits COLD: the full bucket must fit
            if _bucket(len(req.prompt) + len(req.out_tokens)) > \
                    self.cache_len:
                continue
            if req.t_submit > victim_t:
                victim, victim_t = slot, req.t_submit
        return victim

    def _maybe_preempt(self) -> None:
        """Park one decoding row for the longest-pending waiter when its
        queue wait burns the private SLO past the policy's limit: at most
        one park per call, gated by the cooldown. Runs at a window
        boundary, before the next dispatch."""
        pol = self.preemption
        if pol is None or self._slo is None:
            return
        with self._lock:
            waiter = self._holdover[0] if self._holdover else None
            free = any(r is None for r in self._slot_req)
        if waiter is None or free:
            return
        now = tracing.now()
        wait = now - waiter.pending_since
        if wait < pol.threshold_s or \
                self._steps_since_preempt < pol.cooldown_steps:
            return
        # the live head wait: a wedged engine admits nothing, so admit-time
        # observations alone would never show the burn rising
        self._slo.observe("queue_wait", wait, t=now)
        burn = max(self._slo.burn_rates(now=now)["queue_wait"].values())
        if burn < pol.burn_limit:
            return
        with self._lock:
            victim = self._pick_victim(pol)
            if victim is None:
                return
            self._park_slot(victim)
        self._steps_since_preempt = 0
        # the waiter takes the freed slot now; the victim re-enters the
        # pending order behind it (its pending_since just reset)
        self._admit_pending()

    # -- live-session migration (drain) ---------------------------------------

    def _mark_migrated(self, req: _Request, streamed: int) -> None:
        """Complete ``req`` as MIGRATED: ``out_tokens`` is a prefix of the
        final answer, which a resume elsewhere completes
        token-identically."""
        req.migrated = {
            "tokens": list(req.out_tokens),
            "blocks": int(streamed),
            "block_size": self.block_size,
            "kv_dtype": self.kv_dtype,
        }
        req.t_done = tracing.now()
        self.migrated_total += 1
        self._note("migrate", req=req.rid, tokens=len(req.out_tokens),
                   blocks=streamed)
        req.done.set()

    def _migrate_slot(self, slot: int, req: _Request, streamed: int) -> None:
        """Park-for-migrate: free ``slot`` as ``_park_slot`` does
        (committed blocks into the trie, so a bounced-back resume lands
        warm here), but complete the request as migrated."""
        with self._lock:
            if self._slot_req[slot] is not req:
                return  # retired or cancelled since the snapshot
            self._release_committed(slot, req)
        self._mark_migrated(req, streamed)

    def _step_drain(self) -> None:
        """One drain pass (scheduler thread): every pending population
        completes as migrated, then at most ONE live slot advances: one
        chunk of its committed blocks through ``migration_sink``, or,
        once the stream caught up with the decode head (or with no sink),
        its park-for-migrate. The decode windows between passes keep the
        batch emitting; the catch-up terminates because a pass streams
        chunk_blocks * block_size positions while decode advances at most
        one window."""
        with self._lock:
            pending: list[_Request] = list(self._holdover)
            self._holdover.clear()
            pending.extend(self._parked)
            self._parked.clear()
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            staged, self._staged = self._staged, []
            for req, _slot, kv_plan, _tokens in staged:
                table_row, _own, _reuse, total, _spec = kv_plan
                self._pool.unref([int(b) for b in table_row[:total]])
                pending.append(req)
        for req in pending:
            if req.cancelled.is_set():
                req.t_done = tracing.now()
                req.done.set()
                continue
            self._mark_migrated(req, streamed=0)
        sink = self.migration_sink
        stream = final = None
        with self._lock:
            # mid-prefill rows become decoding rows in a pass or two;
            # cancelled rows retire at the next boundary
            prefilling = {t.slot for t in self._prefills}
            for slot, req in enumerate(self._slot_req):
                if req is None or slot in prefilling \
                        or req.cancelled.is_set():
                    continue
                toks = req.prompt + req.out_tokens
                committed = (len(toks) - 1) // self.block_size
                cursor = self._migrate_cursor.get(slot, 0)
                if sink is not None and cursor < committed:
                    n = min(self.migration_chunk_blocks, committed - cursor)
                    stream = (slot, req, toks, cursor, n,
                              list(self._slot_blocks[slot][cursor:cursor + n]))
                else:
                    final = (slot, req, cursor)
                break
        if stream is not None:
            slot, req, toks, cursor, n, blocks = stream
            bs = self.block_size
            # off the lock: only this thread writes the device state
            chunk = self._gather_pages(torch.tensor(
                blocks, dtype=torch.long, device=self.device))
            # recomputed from the tokens: the streamed blocks are
            # slot-held, not yet in the trie
            fps = prefix_fingerprints(toks[:(cursor + n) * bs], bs)
            chunk.update(start_block=cursor,
                         fingerprints=fps[cursor:cursor + n], block_size=bs,
                         kv_dtype=self.kv_dtype)
            try:
                sink(chunk)
            except Exception:  # the sink is injected code
                # a broken sink must not wedge the drain: hand the session
                # off with what already streamed
                self._note("migrate_sink_error", req=req.rid, slot=slot,
                           start_block=cursor)
                self._migrate_slot(slot, req, cursor)
                return
            with self._lock:
                self._migrate_cursor[slot] = cursor + n
                self.migration_chunks_total += 1
                self.migration_blocks_total += n
            self._note("migrate_chunk", req=req.rid, slot=slot,
                       start_block=cursor, blocks=n)
            return
        if final is not None:
            self._migrate_slot(*final)
            return
        # nothing to advance: drained once every population is empty
        with self._lock:
            live = (any(r is not None for r in self._slot_req)
                    or self._spec_group is not None
                    or bool(self._holdover) or bool(self._parked)
                    or bool(self._prefills) or bool(self._staged))
        if not live and self._queue.empty():
            self._drained.set()

    def _group_eligible(self, req: _Request) -> bool:
        """Whether ``req`` goes to a draft group: a speculative engine and
        no draft in the batch itself (verify windows would serve it), no
        live group, a fresh request without repetition penalty, fitting
        the draft cache."""
        with self._lock:
            group_free = self._spec_group is None
        return (self.speculative is not None and self.spec_draft is None
                and group_free and not req.out_tokens
                # a draft group has no paged pool to export from
                and not req.export_kv
                and req.rep_penalty == 1.0
                and self.speculative.fits(len(req.prompt), req.max_new))

    def _drain_spec_group(self, first: _Request):
        """Drain queued requests into ``first``'s draft group: the same
        mode (greedy or sampled), no repetition penalty, the same eos id,
        the same seed for sampled joins (the group's keys derive from the
        head's seed), and every member fitting the draft cache at the
        group's max_new. The first request that cannot join is returned
        as a holdover."""
        group = [first]
        gmax = first.max_new
        head_sampled = first.temperature > 0
        holdover = None
        while len(group) < self.n_slots:
            try:
                nxt = self._queue.get_nowait()
            except queue.Empty:
                break
            if nxt.cancelled.is_set():
                nxt.done.set()
                continue
            cand_max = max(gmax, nxt.max_new)
            if (nxt.rep_penalty == 1.0
                    and (nxt.temperature > 0) == head_sampled
                    and (not head_sampled or nxt.seed == first.seed)
                    and nxt.eos_id == first.eos_id
                    and all(self.speculative.fits(len(m.prompt), cand_max)
                            for m in (*group, nxt))):
                group.append(nxt)
                gmax = cand_max
            else:
                holdover = nxt
                break
        return group, holdover

    def _start_spec_group(self, group: list[_Request]) -> None:
        """Prefill a draft group: rows ride the group's max_new and are
        cut back to their own budgets on the way out; per-row warp knobs;
        keys from the head request's seed."""
        first = group[0]
        try:
            g = self.speculative.start_group(
                [r.prompt for r in group],
                max_new_tokens=max(r.max_new for r in group),
                eos_id=first.eos_id,
                temperatures=[r.temperature for r in group],
                top_ks=[r.top_k for r in group],
                top_ps=[r.top_p for r in group], seed=first.seed)
        except Exception as e:  # the waiters must be released
            for r in group:
                r.failed = f"speculative decode failed: {e}"
                r.done.set()
            return
        with self._lock:
            self._spec_group = (group, g)

    def _step_spec_group(self) -> None:
        """One speculation round of the live group; on completion emit
        each member's tokens and release it. A group whose members are
        all cancelled is dropped."""
        with self._lock:
            live = self._spec_group
        if live is None:
            return
        reqs, g = live
        if all(r.cancelled.is_set() for r in reqs):
            with self._lock:
                if self._spec_group is live:
                    self._spec_group = None
            for r in reqs:
                r.done.set()
            return
        spec_t0 = tracing.now()
        try:
            done = self.speculative.step_group(g)
            out = self.speculative.finish_group(g) if done else None
        except Exception as e:  # the waiters must be released
            with self._lock:
                if self._spec_group is live:
                    self._spec_group = None
            for r in reqs:
                r.failed = f"speculative decode failed: {e}"
                r.done.set()
            return
        # a group's tokens count once it finishes; its earlier rounds
        # record no live token but their time
        emitted = (sum(min(int(out.lengths[b]), r.max_new)
                       for b, r in enumerate(reqs))
                   if out is not None else 0)
        self.profiler.record("spec", bucket=len(reqs), live_rows=len(reqs),
                             live_tokens=emitted, padded_tokens=0,
                             start=spec_t0, end=tracing.now())
        if out is None:
            return
        with self._lock:
            if self._spec_group is not live:
                return  # stop() already failed the members
            self._spec_group = None
        self.spec_accepted += g.accepted_drafts
        now = tracing.now()
        for b, r in enumerate(reqs):
            n = min(int(out.lengths[b]), r.max_new)
            r.out_tokens.extend(out.tokens[b, :n].tolist())
            r.token_times.extend([now] * n)
            r.t_first = r.t_first or now
            self.spec_served += 1
            r.t_done = now
            # a group has no slot timeline: one span covers the residency
            _TRACER.record_span(
                "engine.spec_group", start=r.t_submit, end=now,
                parent=r.trace_parent, tokens=n, group_size=len(reqs))
            r.done.set()

    def _place(self, req: _Request) -> bool:
        """Route one pending request: a draft group if it is eligible, else
        a free slot; False puts it back at the front of the holdover (all
        slots busy or pool short)."""
        if req.cancelled.is_set():
            req.t_done = tracing.now()
            req.done.set()
            return True
        if self._group_eligible(req):
            group, holdover = self._drain_spec_group(req)
            self._start_spec_group(group)
            if holdover is not None:
                with self._lock:
                    # freshly drained from the queue: the newest pending
                    self._holdover.append(holdover)
            return True
        with self._lock:
            for slot in range(self.n_slots):
                if self._slot_req[slot] is None:
                    tokens = req.prompt + req.out_tokens
                    kv_plan = self._plan_kv(
                        tokens, req.max_new - len(req.out_tokens), rid=req.rid)
                    if kv_plan is None:
                        break  # pool backpressure: hold until a retire
                    self._admit(slot, req, kv_plan, tokens)
                    return True
            self._holdover.appendleft(req)
        return False

    def _pop_pending(self) -> _Request | None:
        """Longest-pending-first across the holdover, the parked rows and
        the queue (pulled through the holdover so its head's age
        compares). The anti-livelock order: a just-parked victim's
        ``pending_since`` restarts at its park, so it never readmits
        ahead of the waiter it was parked for."""
        with self._lock:
            if not self._holdover:
                try:
                    self._holdover.append(self._queue.get_nowait())
                except queue.Empty:
                    pass
            hold = self._holdover[0] if self._holdover else None
            park = self._parked[0] if self._parked else None
            if park is not None and (
                    hold is None or park.pending_since <= hold.pending_since):
                return self._parked.pop(0)
            return self._holdover.popleft() if hold is not None else None

    def _admit_pending(self) -> None:
        """Admit the plans staged during the last window, then place
        pending requests until something has to wait."""
        with self._lock:
            staged, self._staged = self._staged, []
        for req, slot, kv_plan, tokens in staged:
            with self._lock:
                if req.cancelled.is_set() or \
                        self._slot_req[slot] is not None:
                    table_row, _own, _reuse, total, _spec = kv_plan
                    self._pool.unref([int(b) for b in table_row[:total]])
                    if req.cancelled.is_set():
                        req.t_done = tracing.now()
                        req.done.set()
                    else:
                        self._holdover.appendleft(req)
                    continue
                self._admit(slot, req, kv_plan, tokens)
        while True:
            req = self._pop_pending()
            if req is None:
                return
            if not self._place(req):
                return

    def _plan_admissions(self) -> None:
        """The host half of admission, overlapped with the in-flight
        decode window: radix match + block alloc for pending requests,
        staged for the next window boundary. No device work here."""
        while True:
            with self._lock:
                taken = {s for _r, s, _p, _t in self._staged}
                free = [s for s in range(self.n_slots)
                        if self._slot_req[s] is None and s not in taken]
            if not free:
                return
            req = self._pop_pending()
            if req is None:
                return
            if req.cancelled.is_set():
                req.t_done = tracing.now()
                req.done.set()
                continue
            if self._group_eligible(req):
                # forming a group dispatches device work: back to the head
                # of the line for _place at the boundary
                with self._lock:
                    self._holdover.appendleft(req)
                return
            with self._lock:
                tokens = req.prompt + req.out_tokens
                kv_plan = self._plan_kv(tokens,
                                        req.max_new - len(req.out_tokens),
                                        rid=req.rid)
                if kv_plan is None:
                    self._holdover.appendleft(req)
                    return
                self._staged.append((req, free[0], kv_plan, tokens))

    def _pick_horizon(self, budgets: list[int], host_work: bool) -> int:
        """Window length: 1 whenever the host has competing work, else the
        largest bucket no row can overshoot (min remaining budget)."""
        if host_work or not budgets:
            return 1
        lim = min(min(budgets), self.max_window)
        k = 1
        for b in self._window_buckets:
            if b <= lim:
                k = b
        return k

    def _commit_steps(self, k: int, prefilling: set) -> list[bool]:
        """The int8 pool's commit gate for a K-step window, from the
        host's own offsets (no sync): step j commits iff some decoding
        row's offset crosses a block edge there. Every decoding row sits
        at offset ``len(prompt) + len(out_tokens) - 1`` and advances K
        positions; each crossing is one quantize-committed block."""
        bs = self.block_size
        steps = [False] * k
        with self._lock:
            for s, r in enumerate(self._slot_req):
                if r is None or s in prefilling:
                    continue
                old = len(r.prompt) + len(r.out_tokens) - 1
                self.quant_blocks_total += (old + k) // bs - old // bs
                for j in range(k):
                    if (old + j + 1) % bs == 0:
                        steps[j] = True
        return steps

    def _flags(self) -> RowFlags:
        c = self._slot_cfg
        return RowFlags.of(c["temperature"], c["top_k"], c["top_p"],
                           c["rep_penalty"])

    def _loop(self) -> None:
        while not self._stop.is_set():
            # staged KV imports first (at most one per pass), idle or not:
            # an import usually precedes the request that wants its
            # blocks, whose admit then finds them warm
            self._step_import()
            with self._lock:
                busy = any(r is not None for r in self._slot_req)
                idle = (not busy and self._spec_group is None
                        and not self._parked)
                # plans staged during the window that retired every live
                # row are pending work too: blocking on the queue would
                # leave them waiting for the next arrival (the reference
                # does, kubeinfer_tpu/inference/batching.py:2815)
                have_holdover = bool(self._holdover) or bool(self._staged)
            if idle:
                if self._draining:
                    # the drain sweeps the queue itself and flips _drained
                    # once every population is empty
                    self._step_drain()
                    self._stop.wait(0.05)
                    continue
                # idle: block briefly for the next arrival
                if not have_holdover:
                    try:
                        nxt = self._queue.get(timeout=0.05)
                    except queue.Empty:
                        continue
                    with self._lock:
                        self._holdover.append(nxt)
                self._admit_pending()
                continue
            if self._draining:
                # admission and preemption stand down; the drain pass
                # streams one chunk (or migrates one caught-up slot) and
                # the window below keeps the batch emitting between chunks
                self._step_drain()
            else:
                self._admit_pending()
                self._maybe_preempt()
            with self._lock:
                # mid-prefill rows are reserved but not decoding
                prefilling = {t.slot for t in self._prefills}
                budgets = [
                    r.max_new - len(r.out_tokens)
                    for s, r in enumerate(self._slot_req)
                    if r is not None and s not in prefilling
                ]
                # verify windows are all-or-nothing: one decoding row
                # without verify slack drops the pass to decode_window
                spec_ready = self.spec_draft is not None and bool(
                    budgets) and all(
                    self._slot_spec_ok[s]
                    for s, r in enumerate(self._slot_req)
                    if r is not None and s not in prefilling)
                host_work = (
                    bool(self._holdover) or bool(self._parked)
                    or bool(self._prefills)
                    or self._spec_group is not None
                    or any(r is not None and r.cancelled.is_set()
                           for r in self._slot_req)
                )
            # draining forces K = 1 too: short windows keep the chunk
            # stream close behind the decode head
            host_work = host_work or not self._queue.empty() or \
                self._draining
            if spec_ready:
                self._verify_pass()
            elif budgets:
                k = self._pick_horizon(budgets, host_work)
                commit_steps = None
                if self.kv_dtype == "int8":
                    commit_steps = self._commit_steps(k, prefilling)
                step_t0 = tracing.now()
                with torch.inference_mode():
                    self._state, tokens = decode_window(
                        self.params, self._state, self.cfg, k, self._flags(),
                        commit_steps)
                # host work overlapped with the device's window (none while
                # draining: the next sweep would unwind the plans), then
                # the window's one readback
                if not self._draining:
                    self._plan_admissions()
                toks = tokens.cpu().numpy()
                step_t = tracing.now()
                self.windows_total += 1
                self._steps_since_preempt += k
                accepted = 0
                with self._lock:
                    for j in range(k):
                        t_j = step_t0 + (j + 1) * (step_t - step_t0) / k
                        for slot in range(self.n_slots):
                            # a row retired at an earlier token of this
                            # window is None here: its tail is masked
                            req = self._slot_req[slot]
                            if req is None or toks[slot, j] < 0:
                                continue
                            req.out_tokens.append(int(toks[slot, j]))
                            req.token_times.append(t_j)
                            if k > 1:
                                req.interpolated = True
                            accepted += 1
                            self._maybe_retire(slot)
                # one record a window, from the stamps around its one
                # readback: the rest of the n_slots x k tokens is padding
                self.profiler.record(
                    "decode", bucket=k, live_rows=len(budgets),
                    live_tokens=accepted,
                    padded_tokens=self.n_slots * k - accepted,
                    start=step_t0, end=step_t, steps=k)
            self._step_prefill()  # at most one chunk per pass
            self._step_spec_group()  # a no-op without a live group
        if self._stop.is_set():
            self._fail_inflight()

    def _verify_pass(self) -> None:
        """One verify window over every slot, its one readback, and the
        host's acceptance: each row emits its device-accepted prefix,
        truncated at EOS and at its budget. A truncation always lands on
        a retirement, so discarded device progress never reaches a row
        that continues. One profiler record a window, bucket spec_k."""
        with self._lock:
            prefilling = {t.slot for t in self._prefills}
            decode_rows = sum(1 for s, r in enumerate(self._slot_req)
                              if r is not None and s not in prefilling)
        step_t0 = tracing.now()
        with torch.inference_mode():
            self._state, self._dstate, tokens = verify_window(
                self.params, self._state, self._dparams, self._dstate,
                self.cfg, self._dcfg, self.spec_k, self._flags())
        if not self._draining:
            # the decode branch's stand-down: no new plans while draining
            self._plan_admissions()
        toks = tokens.cpu().numpy()
        step_t = tracing.now()
        self.windows_total += 1
        self._steps_since_preempt += self.spec_k
        bs = self.block_size
        accepted = 0
        with self._lock:
            for slot in range(self.n_slots):
                req = self._slot_req[slot]
                row = toks[slot]
                n_dev = int((row >= 0).sum())
                if req is None or n_dev == 0:
                    continue
                self.spec_draft_tokens += self.spec_k
                if self.kv_dtype == "int8":
                    # the row sat at p + emitted - 1 and advanced n_dev
                    # positions: one commit per block edge crossed
                    old = len(req.prompt) + len(req.out_tokens) - 1
                    self.quant_blocks_total += (old + n_dev) // bs - old // bs
                n_host = min(n_dev, req.max_new - len(req.out_tokens))
                if req.eos_id >= 0:
                    for i in range(n_host):
                        if int(row[i]) == req.eos_id:
                            n_host = i + 1
                            break
                for j in range(n_host):
                    req.out_tokens.append(int(row[j]))
                    req.token_times.append(
                        step_t0 + (j + 1) * (step_t - step_t0) / n_host)
                if n_host > 1:
                    req.interpolated = True
                accepted += n_host
                # n_dev = the accepted drafts + the bonus token
                acc_d = n_dev - 1
                self.spec_accepted_tokens += acc_d
                req.spec_accepted += acc_d
                if acc_d < self.spec_k:
                    self.spec_rollbacks += 1
                    req.spec_rollbacks += 1
                self._maybe_retire(slot)
        self.profiler.record(
            "verify", bucket=self.spec_k, live_rows=decode_rows,
            live_tokens=accepted,
            padded_tokens=self.n_slots * (self.spec_k + 1) - accepted,
            start=step_t0, end=step_t, steps=self.spec_k)
