"""Attention kernels of the serving and training paths: plain PyTorch
versions, the wrappers that launch the hand-written CUDA kernels, and
the routers.

Seven TPU kernels of ``kubeinfer_tpu/inference/flash_attention.py`` have
counterparts here:

- #9 ``flash_attention_ragged`` (``_run_flash`` + ``_flash_ragged_kernel``):
  prefill attention with the causal + length mask ``(s <= q_offset + t)
  & (s < row_lens[b])`` derived from two scalars. Plain version
  ``flash_attention_ragged_plain``; kernels ``csrc/flash_prefill_tc.cu``
  (bf16 on tensor cores) and ``csrc/flash_prefill.cu`` (the rest).
- #9b ``flash_attention`` (``_run_flash`` + ``_flash_kernel``): the same
  fold over a caller's dense bool [B, T, S] mask. Plain version
  ``flash_attention_plain`` (every key tile); kernels
  ``csrc/flash_prefill_tc.cu`` (bf16: only the key tiles that can add
  anything, ``flash_mask_walk``) and ``csrc/flash_prefill.cu`` (its mask
  instantiation, every key tile).
- #10 ``decode_attention``: T == 1 GQA decode over dense per-row caches,
  reading only each row's live positions. Plain version
  ``decode_attention_plain``; kernel ``csrc/decode_split.cu`` (split-K:
  the cache in splits of ``decode_split_size`` positions across blocks,
  combined in the same launch; ``decode_split_walk`` mirrors which splits
  are live, ``decode_split_combine_plain`` the combine's arithmetic).
- #11 ``decode_attention_blocks``: paged GQA decode through block tables,
  T >= 1 (query t attends positions <= lengths[b] - T + t). Plain version
  ``decode_attention_blocks_plain``; kernel ``csrc/decode_split.cu``.
- #12 ``decode_attention_blocks_q8``: #11 over the int8 pool (int8 pages,
  f32 per-(block, kv head) scales, per-row tails in the compute dtype);
  a tile at or past the row's tail base reads the tail verbatim, any
  other the dequantized page rounded to the compute dtype
  (``_dequant_tile``). Plain version ``decode_attention_blocks_q8_plain``;
  kernel ``csrc/decode_split.cu`` (#11's split-K walk with a loader that
  copies tail pages verbatim and dequantizes committed int8 pages in
  shared memory).
- #13 ``_diff_fwd`` (``_flash_ragged_lse_kernel``): #9's fold plus the
  per-row logsumexp the backward needs. Plain version
  ``flash_ragged_lse_plain``; #9's kernel on the same route with its lse
  output, so its o is bitwise #9's.
- #14 ``_diff_bwd``: dQ (``_flash_bwd_dq_kernel``) and dK/dV
  (``_flash_bwd_dkv_kernel``), recomputing P from the saved lse. Plain
  versions ``flash_bwd_dq_plain``, ``flash_bwd_dkv_plain`` (together
  ``flash_bwd_plain``); kernels ``csrc/flash_backward_tc.cu`` (bf16 with
  D 64 or 128 on tensor cores, walking the tiles of ``flash_bwd_walk``)
  and ``csrc/flash_backward.cu`` (the rest).

Every plain version folds key tiles with ``fold_tile_math``, the
reference's online-softmax step (running max m, normaliser l,
accumulator acc; f32 scores times 1/sqrt(D) plus an additive -1e30
penalty; p rounded to v's dtype before P.V; output acc / max(l, 1e-30)).
They are vectorised over (B, n_kv) and fold EVERY tile: the reference
kernels skip tiles past a row's live length, which is exact (such a
tile adds exactly 0 once the running max is finite), except for rows
that have no live position at all (row_len == 0, or lengths < T), whose
defined output is the uniform average over every tile they name.

Each wrapper takes its plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises (no fallback). ``<wrapper>.launches``
counts kernel launches and nothing else. The prefill wrappers (#9, #9b,
#13) choose their kernel statically by dtype and shape (``tc_route``):
bf16 with D % 64 == 0 (every D ``flash_available`` admits) and G <= 64
takes the tensor-core kernel and also counts ``<wrapper>.tc_launches``;
f32 and other head widths take the CUDA-core kernel, in full f32. The
backward wrappers (#14) choose theirs the same way (``tc_bwd_route``:
bf16 with D 64 or 128). The decode wrappers (#10, #11, #12) launch the
split-K kernel for every CUDA call and, where ``<wrapper>.walk_counter``
holds an int32 CUDA tensor, add to it the live splits the kernel's
blocks walk. The routers (``decode_attention_auto``,
``decode_attention_blocks_auto``, ``decode_attention_blocks_q8_auto``)
bind as the reference's do: the wrapper where the reference's guard
(``decode_flash_available`` with T == 1, ``decode_blocks_available``)
holds on the tensors' device, else the dense ``model.attention`` over
``mask`` (the paged ones over ``gather_block_kv`` /
``dequant_gather_block_kv`` of the pools); every CPU tensor goes
dense. Each router keeps the reference's ``gspmd`` flag, which pins the
dense branch (GSPMD cannot split a Pallas call); the port's tensor
parallel engine (``sharding.py``) calls the routers once per tp rank on
that rank's heads with ``gspmd=False``, so #10, #11 and #12 run on every
shard. ``attention_auto``
is the reference's drop-in for ``forward(attn_fn=...)``: #9b where
``flash_available`` holds, the dense ``model.attention`` elsewhere.
``FlashCausalDiff`` (``flash_attention_causal_diff``) is the reference's
custom_vjp: #9 as the primal, #13 forward and #14 backward under
autograd; ``causal_attention_auto`` binds it for ``model.forward``'s
no-cache path where ``flash_available`` holds.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

# the reference's tiles, read at call time (tests patch them): TILE_S
# tiles the plain versions' key fold, and both set the shapes
# flash_available and the differentiable route admit
TILE_T = 256  # query positions per tile
TILE_S = 512  # key positions per tile
# shapes the kernels take: head width a multiple of 16 up to 256, f32 or
# bf16 operands
KERNEL_MAX_D = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the tensor-core prefill kernel's tiles: a block holds TC_ROWS folded
# query rows (TC_ROWS // G positions x G heads), a key tile TC_KEYS keys
TC_ROWS = 64
TC_KEYS = 64
# the tensor-core backward's dK/dV block: TC_BWD_KEYS keys (two warpgroups
# of TC_KEYS), walking query tiles of TC_ROWS folded rows; its dQ block is
# the forward's (TC_ROWS rows, key tiles of TC_KEYS)
TC_BWD_KEYS = 128
TC_BWD_D = (64, 128)
# the split-K decode kernel (#10, #11, #12): a block walks this many
# consecutive positions of one (row, kv head) of a linear cache, or the
# whole pool pages that make at least DECODE_SPLIT_PAGED
# (decode_split_size), and holds at most DECODE_BLOCK_ROWS[dtype] folded
# query rows (bf16: 4 m-tiles of 16 on the tensor cores; f32: 4 warps of
# 4 on CUDA cores; more rows take further row blocks of the grid)
DECODE_SPLIT_LINEAR = 256
DECODE_SPLIT_PAGED = 128
DECODE_BLOCK_ROWS = {torch.bfloat16: 64, torch.float32: 16}


# --- plain versions ----------------------------------------------------------


def fold_tile_math(q, k, v, pen, m_prev, l_prev, acc_prev, *, groups: int,
                   scale: float):
    """One online-softmax fold over a batch of grid instances.

    q [N, Tq*G, D] folded (t, g) query rows; k, v [N, Sk, D]; pen
    f32[N, Tq, Sk] (0 = attend, -1e30 = masked), broadcast over the G
    sub-rows of each query; m_prev, l_prev f32[N, Tq*G, 1]; acc_prev
    f32[N, Tq*G, D]. Returns (m, l, acc)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    n, tq, sk = pen.shape
    s = (s.reshape(n, tq, groups, sk) + pen[:, :, None, :]).reshape(
        n, tq * groups, sk)
    m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_prev - m_new)
    p = torch.exp(s - m_new)
    l_new = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    pv = torch.matmul(p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_prev * alpha + pv


def _fold_state(qf, tiles, groups: int, scale: float):
    """Run ``fold_tile_math`` over ``tiles`` (an iterable of (k, v, pen))
    from the reference's initial state; returns (m, l, acc)."""
    N, R, D = qf.shape
    m = torch.full((N, R, 1), -1e30, dtype=torch.float32, device=qf.device)
    l = torch.zeros((N, R, 1), dtype=torch.float32, device=qf.device)
    acc = torch.zeros((N, R, D), dtype=torch.float32, device=qf.device)
    for k_t, v_t, pen in tiles:
        m, l, acc = fold_tile_math(qf, k_t, v_t, pen, m, l, acc,
                                   groups=groups, scale=scale)
    return m, l, acc


def _fold_rows(qf, tiles, groups: int, scale: float):
    """``_fold_state``'s acc / max(l, 1e-30)."""
    _, l, acc = _fold_state(qf, tiles, groups, scale)
    return acc / torch.clamp(l, min=1e-30)


def _fold_q(q, n_kv):
    """[B, T, H, D] -> [B*n_kv, T*G, D], (t, g) rows with t outer."""
    B, T, H, D = q.shape
    G = H // n_kv
    return q.reshape(B, T, n_kv, G, D).transpose(1, 2).reshape(
        B * n_kv, T * G, D)


def _unfold_q(out, B, T, H, n_kv):
    G = H // n_kv
    D = out.shape[-1]
    return out.reshape(B, n_kv, T, G, D).transpose(1, 2).reshape(B, T, H, D)


def _linear_kv(k, n_kv):
    """[B, S, n_kv, D] -> [B*n_kv, S, D]."""
    B, S, _, D = k.shape
    return k.transpose(1, 2).reshape(B * n_kv, S, D)


def _ragged_pen(q_pos, s_pos, lens):
    """f32[B*n_kv, T, Sk] penalty of the ragged causal mask (the
    reference's ``_ragged_pen``): 0 where key s_pos is live for query
    position q_pos of a row of length lens, -1e30 elsewhere."""
    ok = (s_pos[None, None, :] <= q_pos[None, :, None]) & (
        s_pos[None, None, :] < lens[:, None, None])
    return torch.where(ok, 0.0, -1e30).float()


def _ragged_state(q, k, v, q_offset, row_lens, tile_s):
    """(m, l, acc) of the ragged fold over the folded rows of q."""
    T, D = q.shape[1], q.shape[3]
    S, n_kv = k.shape[1], k.shape[2]
    dev = q.device
    qf = _fold_q(q, n_kv)
    kf, vf = _linear_kv(k, n_kv), _linear_kv(v, n_kv)
    lens = row_lens.to(device=dev, dtype=torch.int64).repeat_interleave(n_kv)
    q_pos = int(q_offset) + torch.arange(T, device=dev)
    tile_s = min(TILE_S if tile_s is None else tile_s, S)

    def tiles():
        for s0 in range(0, S, tile_s):
            s_pos = torch.arange(s0, min(s0 + tile_s, S), device=dev)
            yield (kf[:, s0:s0 + tile_s], vf[:, s0:s0 + tile_s],
                   _ragged_pen(q_pos, s_pos, lens))

    return _fold_state(qf, tiles(), q.shape[2] // n_kv, 1.0 / float(D) ** 0.5)


def flash_attention_ragged_plain(q, k, v, q_offset, row_lens, *,
                                 tile_s: int | None = None):
    """The chunked-prefill attention: query t of row b (global position
    q_offset + t) attends key s iff s <= q_offset + t and s < row_lens[b].
    q [B, T, H, D], k/v [B, S, n_kv, D], q_offset an int, row_lens i32[B].
    The query tile of the reference kernel does not change any row's
    arithmetic, so all T rows fold together; keys fold in tiles of
    ``tile_s`` (default ``TILE_S`` at call time)."""
    B, T, H, _ = q.shape
    _, l, acc = _ragged_state(q, k, v, q_offset, row_lens, tile_s)
    out = acc / torch.clamp(l, min=1e-30)
    return _unfold_q(out.to(q.dtype), B, T, H, k.shape[2])


def flash_ragged_lse_plain(q, k, v, q_offset, row_lens):
    """#13's function: ``flash_attention_ragged_plain``'s o (the same
    fold, so bitwise equal) and the f32 logsumexp [B*n_kv, T*G, 1] =
    m + log(max(l, 1e-30)) of each folded row (the reference's
    ``_flash_ragged_lse_kernel``)."""
    B, T, H, _ = q.shape
    m, l, acc = _ragged_state(q, k, v, q_offset, row_lens, None)
    out = acc / torch.clamp(l, min=1e-30)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return _unfold_q(out.to(q.dtype), B, T, H, k.shape[2]), lse


def _check_flash_tiles(T, S, tile_t, tile_s):
    """The reference's ``_run_flash`` tile rule for #9b."""
    tile_t, tile_s = min(tile_t, T), min(tile_s, S)
    if T % tile_t or S % tile_s:
        raise ValueError(
            f"flash_attention needs T divisible by {tile_t} and S by "
            f"{tile_s}; got T={T} S={S} (use attention_auto for fallback)")


def flash_attention_plain(q, k, v, mask, *, tile_t: int | None = None,
                          tile_s: int | None = None):
    """#9b's function: query t of row b attends key s iff mask[b, t, s].
    q [B, T, H, D], k/v [B, S, n_kv, D], mask bool [B, T, S]. Every key
    tile is folded with the penalty (mask - 1) * 1e30, as the reference's
    ``_flash_kernel``, so a row with no True gets the uniform mean of v
    over all S keys (the dense softmax's answer). T and S must divide by
    their tiles (``TILE_T``/``TILE_S`` at call time, or smaller)."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    tile_s = TILE_S if tile_s is None else tile_s
    _check_flash_tiles(T, S, TILE_T if tile_t is None else tile_t, tile_s)
    tile_s = min(tile_s, S)
    qf = _fold_q(q, n_kv)
    kf, vf = _linear_kv(k, n_kv), _linear_kv(v, n_kv)

    def tiles():
        for s0 in range(0, S, tile_s):
            # kv-head block bh reads the mask of row bh // n_kv
            pen = (mask[:, :, s0:s0 + tile_s].float() - 1.0) * 1e30
            yield (kf[:, s0:s0 + tile_s], vf[:, s0:s0 + tile_s],
                   pen.repeat_interleave(n_kv, dim=0))

    out = _fold_rows(qf, tiles(), H // n_kv, 1.0 / float(D) ** 0.5)
    return _unfold_q(out.to(q.dtype), B, T, H, n_kv)


def flash_mask_walk(mask, positions: int, keys: int):
    """Which key tiles #9b's tensor-core kernel folds: bool [B,
    ceil(T / positions), ceil(S / keys)] for a bool mask [B, T, S], blocks
    of ``positions`` query positions and tiles of ``keys`` keys (the
    kernel's are ``TC_ROWS // G`` and ``TC_KEYS``). A block whose every
    row (those before T) holds a True somewhere folds the tiles in which
    any of its rows holds one; a block with an all-False row folds every
    tile. Skipping the rest is exact: each skipped tile is masked for
    every row of the block, and every such row has a live key. A plain
    mirror of the kernel's walk for the tests; nothing on the main path
    calls it."""
    B, T, S = mask.shape
    nb, nt = -(-T // positions), -(-S // keys)
    m = torch.zeros((B, nb * positions, nt * keys), dtype=torch.bool,
                    device=mask.device)
    m[:, :T, :S] = mask
    m = m.reshape(B, nb, positions, nt, keys)
    tile_live = m.any(dim=4).any(dim=2)  # [B, nb, nt]
    past_t = (torch.arange(nb * positions, device=mask.device) >= T).reshape(
        nb, positions)
    rows_live = (m.any(dim=4).any(dim=3) | past_t).all(dim=2)  # [B, nb]
    return torch.where(rows_live[:, :, None], tile_live, True)


def flash_bwd_walk(T: int, S: int, q_offset: int, row_lens, G: int):
    """Which (block, tile) steps #14's tensor-core kernels fold, on their
    own tiles (``TC_ROWS // G`` query positions a query tile, ``TC_KEYS``
    keys a dQ key tile, ``TC_BWD_KEYS`` keys a dK/dV block) for T queries
    at ``q_offset`` over S keys, row lengths ``row_lens`` [B] and G query
    heads a kv head. Returns (dq bool [B, query tiles, key tiles], dkv
    bool [B, key blocks, query tiles]). A dQ block folds the key tiles
    before min(S, row_len, its last position + 1), the reference's skip
    rule; a dK/dV block, if its first key s0 lies before min(S, row_len)
    and some query t < T has q_offset + t >= s0, the query tiles from the
    one holding position max(0, s0 - q_offset) to the last. Each kernel
    adds its folded steps to a counter, so on one launch it counts n_kv
    times its grid's sum. A plain mirror of the walks for the tests and
    chip_smoke; nothing on the main path calls it."""
    tb = TC_ROWS // G
    n_q, n_kt = -(-T // tb), -(-S // TC_KEYS)
    n_kb = -(-S // TC_BWD_KEYS)
    lim = torch.as_tensor(row_lens).cpu().to(torch.int64).clamp(max=S)
    ends = torch.clamp((torch.arange(n_q) + 1) * tb, max=T)  # last + 1
    walk = torch.minimum(lim[:, None], int(q_offset) + ends[None, :])
    dq = torch.arange(n_kt)[None, None, :] * TC_KEYS < walk[:, :, None]
    s0 = torch.arange(n_kb) * TC_BWD_KEYS
    t_first = torch.clamp(s0 - int(q_offset), min=0)
    live = (s0[None, :] < lim[:, None]) & (t_first < T)[None, :]
    dkv = live[:, :, None] & (
        torch.arange(n_q)[None, None, :] >= (t_first // tb)[None, :, None])
    return dq, dkv


def _bwd_tiles(q, k, v, do, lse, drow, q_offset, row_lens):
    """The backward's recompute, one reference key tile at a time:
    yields (s0, kf tile, P, dS) with P = exp(q.k * scale + pen - lse),
    gated to 0 on rows with row_len == 0 (the reference's
    ``_recompute_p``), and dS = P * (dO.v - drow), all f32 [B*n_kv, T*G,
    Sk]. Tiles no live pair reaches are skipped (they add exactly 0)."""
    T, H, D = q.shape[1], q.shape[2], q.shape[3]
    S, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv
    dev = q.device
    qf, dof = _fold_q(q, n_kv).float(), _fold_q(do, n_kv).float()
    kf, vf = _linear_kv(k, n_kv), _linear_kv(v, n_kv)
    lens = row_lens.to(device=dev, dtype=torch.int64).repeat_interleave(n_kv)
    q_pos = int(q_offset) + torch.arange(T, device=dev)
    scale = 1.0 / float(D) ** 0.5
    tile_s = min(TILE_S, S)
    live_row = (lens > 0)[:, None, None]
    N = qf.shape[0]
    for s0 in range(0, min(S, int(q_offset) + T), tile_s):
        k_t, v_t = kf[:, s0:s0 + tile_s], vf[:, s0:s0 + tile_s]
        sk = k_t.shape[1]
        pen = _ragged_pen(q_pos, torch.arange(s0, s0 + sk, device=dev), lens)
        s = torch.matmul(qf, k_t.float().transpose(-1, -2)) * scale
        s = (s.reshape(N, T, G, sk) + pen[:, :, None, :]).reshape(
            N, T * G, sk)
        p = torch.where(live_row, torch.exp(s - lse), 0.0)
        dp = torch.matmul(dof, v_t.float().transpose(-1, -2))
        yield s0, k_t, p, p * (dp - drow)


def flash_bwd_dq_plain(q, k, v, do, lse, drow, q_offset, row_lens):
    """#14's dQ: sum over key tiles of (dS rounded to k's dtype) . K,
    times the scale, in f32; [B, T, H, D] in q's dtype. ``lse`` and
    ``drow`` are f32 [B*n_kv, T*G, 1]."""
    B, T, H, D = q.shape
    n_kv = k.shape[2]
    dq = torch.zeros(_fold_q(q, n_kv).shape, dtype=torch.float32,
                     device=q.device)
    scale = 1.0 / float(D) ** 0.5
    for _, k_t, _, ds in _bwd_tiles(q, k, v, do, lse, drow, q_offset,
                                    row_lens):
        dq += torch.matmul(ds.to(k.dtype).float(), k_t.float()) * scale
    return _unfold_q(dq.to(q.dtype), B, T, H, n_kv)


def flash_bwd_dkv_plain(q, k, v, do, lse, drow, q_offset, row_lens):
    """#14's dK and dV: per key tile, (dS rounded to q's dtype)^T . Q
    times the scale and (P rounded to dO's dtype)^T . dO, in f32 over
    every folded row (the GQA group sum); [B, S, n_kv, D] in k's and v's
    dtypes."""
    B, S, n_kv, D = k.shape
    qf, dof = _fold_q(q, n_kv).float(), _fold_q(do, n_kv).float()
    dk = torch.zeros((B * n_kv, S, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    scale = 1.0 / float(D) ** 0.5
    for s0, k_t, p, ds in _bwd_tiles(q, k, v, do, lse, drow, q_offset,
                                     row_lens):
        sk = k_t.shape[1]
        dv[:, s0:s0 + sk] = torch.matmul(
            p.to(do.dtype).float().transpose(-1, -2), dof)
        dk[:, s0:s0 + sk] = torch.matmul(
            ds.to(q.dtype).float().transpose(-1, -2), qf) * scale

    def unfold(x, dtype):
        return x.reshape(B, n_kv, S, D).transpose(1, 2).to(dtype).contiguous()

    return unfold(dk, k.dtype), unfold(dv, v.dtype)


def flash_bwd_noise(q, k, v, do, lse, drow, q_offset, row_lens):
    """How far f32 rounding alone can move #14's dQ and dK, where dS = P *
    (dP - drow) cancels (a query's first key: P = 1, and dP equals drow
    up to rounding, so dS is rounding noise). dP and drow are f32 sums of
    D products, each within D * 2**-24 of eta_t / (D * 2**-22) = sum_d
    |dO_td| max_s |v_sd| (drow's o is a mix of the v rows), so two
    implementations that sum them in other orders (CUDA cores, tensor
    cores) can put dS_ts P_ts * eta_t apart, a margin of 2 included: dQ_t
    by scale * sum_s P_ts eta_t |k_s|, dK_s by scale * sum_t P_ts eta_t
    |q_t|. Returns f32 (dq [B, T, H, D], dk [B, S, n_kv, D]); dV takes no
    dS. For the tests and chip_smoke, which hold each row of dQ and dK to
    2**-6 of its magnitude or to this, whichever is larger; nothing on the
    main path calls it."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    scale = 1.0 / float(D) ** 0.5
    qa = _fold_q(q, n_kv).float().abs()
    vmax = _linear_kv(v, n_kv).float().abs().amax(dim=1)  # [N, D]
    eta = D * 2.0 ** -22 * torch.matmul(_fold_q(do, n_kv).float().abs(),
                                        vmax[:, :, None])  # [N, R, 1]
    dq = torch.zeros_like(qa)
    dk = torch.zeros((B * n_kv, S, D), dtype=torch.float32, device=q.device)
    for s0, k_t, p, _ in _bwd_tiles(q, k, v, do, lse, drow, q_offset,
                                    row_lens):
        pe = p * eta
        dq += torch.matmul(pe, k_t.float().abs()) * scale
        dk[:, s0:s0 + k_t.shape[1]] = torch.matmul(
            pe.transpose(-1, -2), qa) * scale
    return (_unfold_q(dq, B, T, H, n_kv),
            dk.reshape(B, n_kv, S, D).transpose(1, 2))


def flash_bwd_drow(o, do, n_kv):
    """rowsum(dO * O) in f32, folded to [B*n_kv, T*G, 1]: the backward's
    shared operand, computed outside the kernels as the reference does."""
    return _fold_q((do.float() * o.float()).sum(-1, keepdim=True), n_kv)


def flash_bwd_plain(q, k, v, q_offset, row_lens, o_folded, lse, do):
    """#14 whole, on the reference's ``_diff_bwd`` residuals (o folded
    [B*n_kv, T*G, D], lse f32 [B*n_kv, T*G, 1]): (dq, dk, dv)."""
    n_kv = k.shape[2]
    drow = (_fold_q(do, n_kv).float() * o_folded.float()).sum(
        -1, keepdim=True)
    dq = flash_bwd_dq_plain(q, k, v, do, lse, drow, q_offset, row_lens)
    dk, dv = flash_bwd_dkv_plain(q, k, v, do, lse, drow, q_offset, row_lens)
    return dq, dk, dv


def decode_attention_plain(q, k, v, lengths, *, tile_s: int = TILE_S):
    """T == 1 decode: row b attends its first ``lengths[b]`` positions.
    q [B, 1, H, D], k/v [B, S, n_kv, D], lengths i32[B]."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"decode_attention is T == 1 only; got T={T}")
    S, n_kv = k.shape[1], k.shape[2]
    dev = q.device
    qf = _fold_q(q, n_kv)
    kf, vf = _linear_kv(k, n_kv), _linear_kv(v, n_kv)
    lens = lengths.to(device=dev, dtype=torch.int64).repeat_interleave(n_kv)
    tile_s = min(tile_s, S)

    def tiles():
        for s0 in range(0, S, tile_s):
            s_pos = torch.arange(s0, min(s0 + tile_s, S), device=dev)
            pen = torch.where(s_pos[None, None, :] < lens[:, None, None],
                              0.0, -1e30).float()
            yield kf[:, s0:s0 + tile_s], vf[:, s0:s0 + tile_s], pen

    out = _fold_rows(qf, tiles(), H // n_kv, 1.0 / float(D) ** 0.5)
    return _unfold_q(out.to(q.dtype), B, T, H, n_kv)


def decode_attention_blocks_plain(q, k_pool, v_pool, block_tables, lengths):
    """Paged decode: row b's logical position p lives in pool block
    ``block_tables[b, p // bs]`` at slot ``p % bs``; query t attends
    positions <= lengths[b] - T + t. q [B, T, H, D], pools [NB, bs, n_kv,
    D], block_tables i32[B, M] (every entry a valid pool index), lengths
    i32[B]. One tile per table entry, gathered as the reference's twin
    gathers it."""
    B, T, H, D = q.shape
    bs, n_kv = k_pool.shape[1], k_pool.shape[2]
    M = block_tables.shape[1]
    dev = q.device
    qf = _fold_q(q, n_kv)
    tbl = block_tables.to(device=dev, dtype=torch.int64)
    lens = lengths.to(device=dev, dtype=torch.int64).repeat_interleave(n_kv)
    q_pos = lens[:, None] - T + torch.arange(T, device=dev)[None, :]

    def tiles():
        for j in range(M):
            blk = tbl[:, j]
            k_t = k_pool[blk].transpose(1, 2).reshape(B * n_kv, bs, D)
            v_t = v_pool[blk].transpose(1, 2).reshape(B * n_kv, bs, D)
            s_pos = j * bs + torch.arange(bs, device=dev)
            pen = torch.where(s_pos[None, None, :] <= q_pos[:, :, None],
                              0.0, -1e30).float()
            yield k_t, v_t, pen

    out = _fold_rows(qf, tiles(), H // n_kv, 1.0 / float(D) ** 0.5)
    return _unfold_q(out.to(q.dtype), B, T, H, n_kv)


def decode_split_size(width: int, paged: bool) -> int:
    """C, the positions one block of the split-K decode kernel walks: for
    a linear cache (``width`` = S) ``DECODE_SPLIT_LINEAR``; for a pool of
    blocks of ``width`` positions the whole pages that make at least
    ``DECODE_SPLIT_PAGED``. From the cache geometry alone: the host never
    reads the lengths. (A split has a fixed cost, its partial and its share
    of the combine; on an H100, llama-3-8b's 4101-position engine row ran
    faster in splits of 256 than of 128, eight pool rows of 515 faster in
    single pages than in pairs.)"""
    if not paged:
        return DECODE_SPLIT_LINEAR
    return width * -(-DECODE_SPLIT_PAGED // width)


def decode_row_blocks(rows: int, dtype) -> int:
    """Blocks of the split-K grid over the ``rows`` = T * G folded query
    rows of one (row, kv head, split)."""
    return -(-rows // DECODE_BLOCK_ROWS[dtype])


def decode_split_walk(lengths, T: int, S_total: int, C: int):
    """The live splits of each row: ceil(walk / C), walk = min(len,
    S_total) for a row with len >= T and S_total (every position the row
    names) for one with len < T. int64 [B] on the lengths' device, with
    no host sync. One kernel launch adds n_kv * decode_row_blocks(T * G,
    dtype) times its sum to ``walk_counter``. A plain mirror of the
    kernel's walk for the tests and chip_smoke; nothing on the main path
    calls it."""
    lens = lengths.to(torch.int64)
    walk = torch.where(lens < T, S_total, torch.clamp(lens, max=S_total))
    return (walk + C - 1) // C


def decode_split_combine_plain(q, k, v, lengths, C: int):
    """The split-K kernel's arithmetic in plain PyTorch: each live split
    of C positions folded on its own from the reference's initial state
    (``_fold_state``), then out = sum_s e^{m_s - m} acc_s / max(sum_s
    e^{m_s - m} l_s, 1e-30) with m = max_s m_s over the live splits
    (``decode_split_walk``), taken as the kernel takes it: the splits in
    order, in running form. q [B, T, H, D] over a linear cache k, v [B,
    S, n_kv, D] (a paged pool gathered through its tables first); query t
    attends positions <= lengths[b] - T + t. For the tests only."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    dev = q.device
    qf = _fold_q(q, n_kv)
    kf, vf = _linear_kv(k, n_kv), _linear_kv(v, n_kv)
    lens = lengths.to(device=dev, dtype=torch.int64).repeat_interleave(n_kv)
    q_pos = lens[:, None] - T + torch.arange(T, device=dev)[None, :]
    n_live = decode_split_walk(lengths.to(dev), T, S, C).repeat_interleave(
        n_kv)
    scale = 1.0 / float(D) ** 0.5
    N, R = qf.shape[0], qf.shape[1]
    m = torch.full((N, R, 1), -1e30, dtype=torch.float32, device=dev)
    L = torch.zeros((N, R, 1), dtype=torch.float32, device=dev)
    A = torch.zeros((N, R, D), dtype=torch.float32, device=dev)
    for i, s0 in enumerate(range(0, S, C)):
        s_pos = torch.arange(s0, min(s0 + C, S), device=dev)
        pen = torch.where(s_pos[None, None, :] <= q_pos[:, :, None], 0.0,
                          -1e30).float()
        m_s, l_s, acc_s = _fold_state(
            qf, [(kf[:, s0:s0 + C], vf[:, s0:s0 + C], pen)], H // n_kv, scale)
        # a split past the row's walk takes no part
        live = (i < n_live)[:, None, None]
        mn = torch.where(live, torch.maximum(m, m_s), m)
        ea = torch.exp(m - mn)
        eb = torch.where(live, torch.exp(m_s - mn), 0.0)
        L, A, m = L * ea + l_s * eb, A * ea + acc_s * eb, mn
    out = A / torch.clamp(L, min=1e-30)
    return _unfold_q(out.to(q.dtype), B, T, H, n_kv)


def _dequant_tile(kq, scale, tail, use_tail, out_dtype):
    """One tile's effective K (or V) for a batch of rows: the int8 page
    [B, bs, n_kv, D] dequantized in f32 with its [B, n_kv] scales, or the
    tail tile verbatim where ``use_tail`` [B]; rounded to the compute
    dtype before the fold (the reference's ``_dequant_tile``)."""
    deq = kq.float() * scale[:, None, :, None]
    return torch.where(use_tail[:, None, None, None], tail.float(),
                       deq).to(out_dtype)


def decode_attention_blocks_q8_plain(q, k_pool, v_pool, k_scales, v_scales,
                                     k_tail, v_tail, block_tables, lengths):
    """``decode_attention_blocks_plain`` over the int8 pool: int8 pages
    [NB, bs, n_kv, D], f32 scales [NB, n_kv], per-row tails [B, 2, bs,
    n_kv, D] in q's dtype. Tile j of row b reads tail slot
    ``min(j - tb, 1)`` when ``j >= tb = max(lengths[b] - T, 0) // bs``
    (the window's start block, derived here as the reference derives
    it), else the dequantized page ``block_tables[b, j]``."""
    B, T, H, D = q.shape
    bs, n_kv = k_pool.shape[1], k_pool.shape[2]
    M = block_tables.shape[1]
    dev = q.device
    qf = _fold_q(q, n_kv)
    tbl = block_tables.to(device=dev, dtype=torch.int64)
    lens_b = lengths.to(device=dev, dtype=torch.int64)
    tb = torch.clamp(lens_b - T, min=0) // bs
    lens = lens_b.repeat_interleave(n_kv)
    q_pos = lens[:, None] - T + torch.arange(T, device=dev)[None, :]
    rows = torch.arange(B, device=dev)

    def eff(pool, scales, tail, j, use_tail, rel):
        blk = tbl[:, j]
        t = _dequant_tile(pool[blk], scales[blk], tail[rows, rel], use_tail,
                          q.dtype)
        return t.transpose(1, 2).reshape(B * n_kv, bs, D)

    def tiles():
        for j in range(M):
            use_tail = j >= tb
            rel = torch.clamp(j - tb, 0, 1)
            s_pos = j * bs + torch.arange(bs, device=dev)
            pen = torch.where(s_pos[None, None, :] <= q_pos[:, :, None],
                              0.0, -1e30).float()
            yield (eff(k_pool, k_scales, k_tail, j, use_tail, rel),
                   eff(v_pool, v_scales, v_tail, j, use_tail, rel), pen)

    out = _fold_rows(qf, tiles(), H // n_kv, 1.0 / float(D) ** 0.5)
    return _unfold_q(out.to(q.dtype), B, T, H, n_kv)


# --- kernel wrappers ---------------------------------------------------------


_libs: dict = {}  # the loaded kernel libraries, by name


def _kernel_lib(t: torch.Tensor, name: str, lib_name: str):
    """The kernel library for a CUDA tensor (built at first use); None for
    a CPU tensor, where the wrapper ``name`` takes its plain version."""
    kind = t.device.type
    if kind == "cuda":
        lib = _libs.get(lib_name)
        if lib is not None:
            return lib
    elif kind == "cpu":
        return None
    else:
        raise ValueError(f"{name}: unsupported device {t.device}")
    from kubeinfer_tpu_torch._build import load_kernel_library

    lib = _libs[lib_name] = load_kernel_library(lib_name)
    return lib


def _check(name, t, dtype, shape, device, align=16):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must be {align}-byte aligned")


def _check_head(name, q, D):
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"not {q.dtype}")
    if D % 16 or D > KERNEL_MAX_D:
        raise ValueError(f"{name}: the kernel takes head widths D % 16 == 0 "
                         f"and D <= {KERNEL_MAX_D}; got D={D} for q "
                         f"{tuple(q.shape)}")


_CURRENT = contextlib.nullcontext()


def on_device(dev: torch.device):
    """The context to call a launcher in for tensors on ``dev``. The
    launchers act on the current CUDA device (``cudaGetDevice``,
    ``cudaFuncSetAttribute``, the launch itself), and the tensor parallel
    engine drives every rank from one thread, so a rank on another card
    launches under ``torch.cuda.device(dev)``; a null context when
    ``dev`` is already current (one device query of host time)."""
    if torch._C._cuda_getDevice() == dev.index:
        return _CURRENT
    return torch.cuda.device(dev)


def _launch(lib, fn: str, *args) -> None:
    """Call one launcher under its tensors' device; tensors and the
    stream cross as c_void_p, floats as c_float, ints as c_int. A nonzero
    cudaError_t raises."""
    conv = []
    for a in args:
        if a is None:  # a null pointer
            conv.append(ctypes.c_void_p(None))
        elif isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif isinstance(a, float):
            conv.append(ctypes.c_float(a))
        else:
            conv.append(int(a))
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    with on_device(dev):
        err = getattr(lib, fn)(*conv, ctypes.c_void_p(
            torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.error_string(err)}")


# the split-K kernel's tickets: int32, one per (row, kv head, row block)
# of the largest grid launched on a (device, stream), zeroed once when
# allocated; every launch leaves them zero
_tickets: dict = {}


def _split_tickets(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int32, device=dev)
        _tickets[key] = buf
    return buf


def _check_split(specs, dev) -> None:
    """``_check`` of each (name, tensor, dtype, shape, alignment) in
    ``specs`` on ``dev``, at a few attribute reads a tensor: the split-K
    wrappers run about 2000 times a serving decode step, on the host."""
    for name, t, dtype, shape, align in specs:
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % align):
            _check(name, t, dtype, shape, dev, align)  # raises


def _split_launch(wrapper, lib, fn, q, operands, n_kv, S_total, C, ints):
    """One launch of the split-K kernel: q's folded rows over S_total
    positions in splits of C; ``operands`` the tensors before ``out``,
    ``ints`` the launcher's ints before C. Allocates the output and the
    f32 partials (the caching allocator), takes the tickets, passes
    ``wrapper.walk_counter`` (or null) and counts the launch."""
    B, T, H, D = q.shape
    R = T * (H // n_kv)
    dev = q.device
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object, several us of host time a call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = torch.empty_like(q)
    n_split = -(-S_total // C)
    ws = torch.empty(B * n_kv * n_split * R * (D + 2), dtype=torch.float32,
                     device=dev)
    tickets = _split_tickets(dev, stream,
                             B * n_kv * decode_row_blocks(R, q.dtype))
    walked = wrapper.walk_counter
    if walked is not None:
        _check("walk_counter", walked, torch.int32, (1,), dev, align=4)
    with on_device(dev):
        err = getattr(lib, fn)(
            *(t.data_ptr() for t in operands), out.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(),
            None if walked is None else walked.data_ptr(), *ints, C,
            1.0 / float(D) ** 0.5, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.error_string(err)}")
    wrapper.launches += 1
    return out


def decode_attention(q, k, v, lengths):
    """#10 on the tensors' device: for CUDA tensors one launch of
    ``decode_split_launch`` (split-K over ``decode_split_size(S, False)``
    positions a block, live splits only, combined in the same launch);
    for CPU tensors ``decode_attention_plain``. Where
    ``decode_attention.walk_counter`` holds an int32 CUDA tensor of one
    element, the launch adds to it n_kv times the sum of
    ``decode_split_walk(lengths, 1, S, C)``."""
    lib = _kernel_lib(q, "decode_attention", "decode_split")
    if lib is None:
        return decode_attention_plain(q, k, v, lengths)
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    if T != 1:
        raise ValueError(f"decode_attention is T == 1 only; got q "
                         f"{tuple(q.shape)}")
    _check_head("decode_attention", q, D)
    if H % n_kv:
        raise ValueError(f"decode_attention: {H} heads over {n_kv} kv heads")
    dt = q.dtype
    _check_split((("q", q, dt, (B, 1, H, D), 16),
                  ("k", k, dt, (B, S, n_kv, D), 16),
                  ("v", v, dt, (B, S, n_kv, D), 16),
                  ("lengths", lengths, torch.int32, (B,), 4)), q.device)
    return _split_launch(decode_attention, lib, "decode_split_launch", q,
                         (q, k, v, lengths), n_kv, S,
                         decode_split_size(S, False), (B, H, n_kv, D, S))


decode_attention.launches = 0
decode_attention.walk_counter = None


def decode_attention_blocks(q, k_pool, v_pool, block_tables, lengths):
    """#11 on the tensors' device: for CUDA tensors one launch of
    ``decode_split_blocks_launch`` (split-K over ``decode_split_size(bs,
    True)`` positions, whole pages, a block); for CPU tensors
    ``decode_attention_blocks_plain``. ``walk_counter`` as for #10, with
    S_total = M * bs and n_kv * decode_row_blocks(T * G, dtype) blocks a
    split."""
    lib = _kernel_lib(q, "decode_attention_blocks", "decode_split")
    if lib is None:
        return decode_attention_blocks_plain(q, k_pool, v_pool, block_tables,
                                             lengths)
    B, T, H, D = q.shape
    NB, bs, n_kv = k_pool.shape[:3]
    M = block_tables.shape[1]
    _check_head("decode_attention_blocks", q, D)
    if H % n_kv:
        raise ValueError(f"decode_attention_blocks: {H} heads over {n_kv} "
                         "kv heads")
    dt = q.dtype
    _check_split((("q", q, dt, (B, T, H, D), 16),
                  ("k_pool", k_pool, dt, (NB, bs, n_kv, D), 16),
                  ("v_pool", v_pool, dt, (NB, bs, n_kv, D), 16),
                  ("block_tables", block_tables, torch.int32, (B, M), 4),
                  ("lengths", lengths, torch.int32, (B,), 4)), q.device)
    return _split_launch(decode_attention_blocks, lib,
                         "decode_split_blocks_launch", q,
                         (q, k_pool, v_pool, block_tables, lengths), n_kv,
                         M * bs, decode_split_size(bs, True),
                         (B, T, H, n_kv, D, bs, M))


decode_attention_blocks.launches = 0
decode_attention_blocks.walk_counter = None


def decode_attention_blocks_q8(q, k_pool, v_pool, k_scales, v_scales, k_tail,
                               v_tail, block_tables, lengths):
    """#12 on the tensors' device: for CUDA tensors one launch of
    ``decode_split_blocks_q8_launch`` (#11's split-K walk, whose loader
    copies a page at or past the row's tail base from the tail verbatim
    and dequantizes any other from its int8 codes and scale); for CPU
    tensors ``decode_attention_blocks_q8_plain``. ``walk_counter`` as for
    #11."""
    lib = _kernel_lib(q, "decode_attention_blocks_q8", "decode_split")
    if lib is None:
        return decode_attention_blocks_q8_plain(
            q, k_pool, v_pool, k_scales, v_scales, k_tail, v_tail,
            block_tables, lengths)
    B, T, H, D = q.shape
    NB, bs, n_kv = k_pool.shape[:3]
    M = block_tables.shape[1]
    _check_head("decode_attention_blocks_q8", q, D)
    if H % n_kv:
        raise ValueError(f"decode_attention_blocks_q8: {H} heads over {n_kv} "
                         "kv heads")
    dt, i8, f32 = q.dtype, torch.int8, torch.float32
    pages, tails = (NB, bs, n_kv, D), (B, 2, bs, n_kv, D)
    _check_split((("q", q, dt, (B, T, H, D), 16),
                  ("k_pool", k_pool, i8, pages, 16),
                  ("v_pool", v_pool, i8, pages, 16),
                  ("k_scales", k_scales, f32, (NB, n_kv), 4),
                  ("v_scales", v_scales, f32, (NB, n_kv), 4),
                  ("k_tail", k_tail, dt, tails, 16),
                  ("v_tail", v_tail, dt, tails, 16),
                  ("block_tables", block_tables, torch.int32, (B, M), 4),
                  ("lengths", lengths, torch.int32, (B,), 4)), q.device)
    return _split_launch(decode_attention_blocks_q8, lib,
                         "decode_split_blocks_q8_launch", q,
                         (q, k_pool, v_pool, k_scales, v_scales, k_tail,
                          v_tail, block_tables, lengths), n_kv, M * bs,
                         decode_split_size(bs, True),
                         (B, T, H, n_kv, D, bs, M))


decode_attention_blocks_q8.launches = 0
decode_attention_blocks_q8.walk_counter = None


def _check_ragged(name, q, k, v, row_lens, extra=()):
    """The shapes, types and layout the prefill kernels (#9, #9b, #13,
    #14) take (``row_lens`` None for #9b); ``extra`` holds (name, tensor,
    dtype, shape, alignment) of further operands."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    _check_head(name, q, D)
    if H % n_kv:
        raise ValueError(f"{name}: {H} heads over {n_kv} kv heads")
    dev = q.device
    _check("q", q, q.dtype, (B, T, H, D), dev)
    _check("k", k, q.dtype, (B, S, n_kv, D), dev)
    _check("v", v, q.dtype, (B, S, n_kv, D), dev)
    if row_lens is not None:
        _check("row_lens", row_lens, torch.int32, (B,), dev, align=4)
    for what, t, dtype, shape, align in extra:
        _check(what, t, dtype, shape, dev, align=align)


def tc_route(q, n_kv) -> bool:
    """Whether the prefill wrappers (#9, #9b, #13) launch the tensor-core
    kernel (``csrc/flash_prefill_tc.cu``) for q [B, T, H, D] over n_kv kv
    heads: bf16 with D % 64 == 0 up to 256 and G = H / n_kv <= TC_ROWS.
    Otherwise (f32, other head widths) they launch the CUDA-core kernel
    (``csrc/flash_prefill.cu``), f32 in full f32. A static choice, not a
    fallback: the chosen kernel launches or the wrapper raises."""
    D, G = q.shape[3], q.shape[2] // n_kv
    return (q.dtype == torch.bfloat16 and D % 64 == 0 and D <= KERNEL_MAX_D
            and G <= TC_ROWS)


def tc_bwd_route(q, n_kv) -> bool:
    """Whether the backward wrappers (#14) launch the tensor-core kernels
    (``csrc/flash_backward_tc.cu``) for q [B, T, H, D] over n_kv kv heads:
    bf16 with D in ``TC_BWD_D`` (64, 128: dK and dV of 64 keys must fit
    one warpgroup's registers) and G = H / n_kv <= TC_ROWS. Otherwise
    (f32, other head widths) they launch the CUDA-core kernels
    (``csrc/flash_backward.cu``), f32 in full f32. A static choice, not a
    fallback: the chosen kernel launches or the wrapper raises."""
    D, G = q.shape[3], q.shape[2] // n_kv
    return q.dtype == torch.bfloat16 and D in TC_BWD_D and G <= TC_ROWS


def _prefill_lib(q, name, n_kv):
    """(library, tensor-core route?) for a prefill wrapper; library None
    for a CPU tensor."""
    tc = tc_route(q, n_kv)
    return _kernel_lib(q, name, "flash_prefill_tc" if tc else
                       "flash_prefill"), tc


def _launch_ragged(lib, tc, q, k, v, q_offset, row_lens, out, lse):
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    args = (q, k, v, row_lens, out, lse, B, T, S, H, n_kv, D, int(q_offset),
            1.0 / float(D) ** 0.5)
    if tc:
        _launch(lib, "flash_prefill_tc_launch", *args)
    else:
        _launch(lib, "flash_prefill_launch", *args, _DTYPES[q.dtype])


def flash_attention_ragged(q, k, v, q_offset, row_lens):
    """#9 on the tensors' device: for CUDA tensors one launch (grid of
    (B*n_kv, query-row tiles), walking only the key tiles the causal +
    length rule admits) of ``flash_prefill_tc_launch`` where ``tc_route``
    holds, else of ``flash_prefill_launch``; for CPU tensors
    ``flash_attention_ragged_plain``. ``q_offset`` is a host int."""
    lib, tc = _prefill_lib(q, "flash_attention_ragged", k.shape[2])
    if lib is None:
        return flash_attention_ragged_plain(q, k, v, q_offset, row_lens)
    _check_ragged("flash_attention_ragged", q, k, v, row_lens)
    out = torch.empty_like(q)
    _launch_ragged(lib, tc, q, k, v, q_offset, row_lens, out, None)
    flash_attention_ragged.launches += 1
    flash_attention_ragged.tc_launches += tc
    return out


flash_attention_ragged.launches = 0
flash_attention_ragged.tc_launches = 0


def flash_ragged_lse(q, k, v, q_offset, row_lens):
    """#13 on the tensors' device: (o, lse) as ``flash_ragged_lse_plain``.
    For CUDA tensors one launch of #9's kernel on #9's route with its lse
    output (the same code and walk, so o is bitwise #9's); for CPU
    tensors the plain version."""
    lib, tc = _prefill_lib(q, "flash_ragged_lse", k.shape[2])
    if lib is None:
        return flash_ragged_lse_plain(q, k, v, q_offset, row_lens)
    B, T, H, _ = q.shape
    n_kv = k.shape[2]
    _check_ragged("flash_ragged_lse", q, k, v, row_lens)
    out = torch.empty_like(q)
    lse = torch.empty((B * n_kv, T * (H // n_kv), 1), dtype=torch.float32,
                      device=q.device)
    _launch_ragged(lib, tc, q, k, v, q_offset, row_lens, out, lse)
    flash_ragged_lse.launches += 1
    flash_ragged_lse.tc_launches += tc
    return out, lse


flash_ragged_lse.launches = 0
flash_ragged_lse.tc_launches = 0


def flash_attention(q, k, v, mask):
    """#9b on the tensors' device: for CUDA tensors one launch of
    ``flash_masked_tc_launch`` where ``tc_route`` holds (folding only the
    key tiles of ``flash_mask_walk``), else of ``flash_masked_launch``
    (#9's CUDA-core kernel with a mask tile loader, every key tile); for
    CPU tensors ``flash_attention_plain``. ``mask`` is bool [B, T, S],
    passed as its bytes. Where ``flash_attention.walk_counter`` holds an
    int32 CUDA tensor of one element, each tensor-core launch adds to it
    the key tiles its blocks fold, summed over every (batch row, kv
    head, query block): n_kv times the sum of ``flash_mask_walk``, the
    walk's plain mirror, if the kernel walks as that says."""
    lib, tc = _prefill_lib(q, "flash_attention", k.shape[2])
    if lib is None:
        return flash_attention_plain(q, k, v, mask)
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    _check_flash_tiles(T, S, TILE_T, TILE_S)
    _check_ragged("flash_attention", q, k, v, None,
                  extra=(("mask", mask, torch.bool, (B, T, S), 1),))
    out = torch.empty_like(q)
    args = (B, T, S, H, n_kv, D, 1.0 / float(D) ** 0.5)
    if tc:
        walked = flash_attention.walk_counter
        if walked is not None:
            _check("walk_counter", walked, torch.int32, (1,), q.device,
                   align=4)
        _launch(lib, "flash_masked_tc_launch", q, k, v, mask, out, walked,
                *args)
    else:
        _launch(lib, "flash_masked_launch", q, k, v, mask, out, *args,
                _DTYPES[q.dtype])
    flash_attention.launches += 1
    flash_attention.tc_launches += tc
    return out


flash_attention.launches = 0
flash_attention.tc_launches = 0
flash_attention.walk_counter = None


def _bwd_operands(name, q, k, v, do, lse, drow, row_lens):
    B, T, H, _ = q.shape
    R = T * (H // k.shape[2])
    N = B * k.shape[2]
    _check_ragged(name, q, k, v, row_lens, extra=(
        ("do", do, q.dtype, tuple(q.shape), 16),
        ("lse", lse, torch.float32, (N, R, 1), 4),
        ("drow", drow, torch.float32, (N, R, 1), 4)))


def _bwd_launch(wrapper, name, q, k, v, do, lse, drow, q_offset, row_lens,
                outs):
    """One #14 launch of ``name`` (``flash_bwd_dq`` or ``flash_bwd_dkv``)
    writing ``outs``: the tensor-core kernel where ``tc_bwd_route`` holds
    (with ``wrapper.walk_counter``, if set, as its walk counter), else the
    CUDA-core kernel; counts ``wrapper.launches`` and ``tc_launches``."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    tc = tc_bwd_route(q, n_kv)
    lib = _kernel_lib(q, name, "flash_backward_tc" if tc else
                      "flash_backward")
    _bwd_operands(name, q, k, v, do, lse, drow, row_lens)
    head = (q, k, v, do, lse, drow, row_lens, *outs)
    tail = (B, T, S, H, n_kv, D, int(q_offset), 1.0 / float(D) ** 0.5)
    if tc:
        walked = wrapper.walk_counter
        if walked is not None:
            _check("walk_counter", walked, torch.int32, (1,), q.device,
                   align=4)
        _launch(lib, f"{name}_tc_launch", *head, walked, *tail)
    else:
        _launch(lib, f"{name}_launch", *head, *tail, _DTYPES[q.dtype])
    wrapper.launches += 1
    wrapper.tc_launches += tc


def flash_bwd_dq(q, k, v, do, lse, drow, q_offset, row_lens):
    """#14's dQ on the tensors' device: for CUDA tensors one launch (a
    block per folded query-row tile, walking the live key tiles) of
    ``flash_bwd_dq_tc_launch`` where ``tc_bwd_route`` holds, else of
    ``flash_bwd_dq_launch``; for CPU tensors ``flash_bwd_dq_plain``.
    Where ``flash_bwd_dq.walk_counter`` holds an int32 CUDA tensor of one
    element, a tensor-core launch adds to it the key tiles its blocks
    fold: n_kv times ``flash_bwd_walk``'s dq sum."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, drow, q_offset, row_lens)
    dq = torch.empty_like(q)
    _bwd_launch(flash_bwd_dq, "flash_bwd_dq", q, k, v, do, lse, drow,
                q_offset, row_lens, (dq,))
    return dq


flash_bwd_dq.launches = 0
flash_bwd_dq.tc_launches = 0
flash_bwd_dq.walk_counter = None


def flash_bwd_dkv(q, k, v, do, lse, drow, q_offset, row_lens):
    """#14's dK and dV on the tensors' device: for CUDA tensors one launch
    (a block per key block, walking the query-row tiles that see it) of
    ``flash_bwd_dkv_tc_launch`` where ``tc_bwd_route`` holds, else of
    ``flash_bwd_dkv_launch``; for CPU tensors ``flash_bwd_dkv_plain``.
    ``flash_bwd_dkv.walk_counter`` as for dQ, counting the query tiles
    its blocks fold: n_kv times ``flash_bwd_walk``'s dkv sum."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, drow, q_offset,
                                   row_lens)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch(flash_bwd_dkv, "flash_bwd_dkv", q, k, v, do, lse, drow,
                q_offset, row_lens, (dk, dv))
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0
flash_bwd_dkv.walk_counter = None


# --- routers -----------------------------------------------------------------


def decode_flash_available(S: int, D: int, device) -> bool:
    """The reference's guard on the linear caches its decode kernel (#10)
    takes, word for word, with its accelerator test read as "``device``
    is CUDA": ``flash_available``'s contract without the T terms."""
    return (
        torch.device(device).type == "cuda"
        and S % min(TILE_S, S) == 0
        and S % 128 == 0
        and S >= 128
        and D % 64 == 0
    )


def decode_blocks_available(block_size: int, D: int, device) -> bool:
    """The reference's guard on the pools its paged decode kernels (#11,
    #12) take, word for word, with its accelerator test read as
    "``device`` is CUDA": ``decode_flash_available`` with S replaced by
    the pool's block size. Small-block configs take the gather + dense
    route."""
    return (
        torch.device(device).type == "cuda"
        and block_size % 128 == 0
        and block_size >= 128
        and D % 64 == 0
    )


def gather_block_kv(pool, block_tables):
    """[num_blocks, bs, n_kv, D] pool -> [B, max_blocks * bs, n_kv, D],
    each row's linear view through its table (the reference's
    ``gather_block_kv``): the dense route's K/V."""
    _, bs, n_kv, D = pool.shape
    B, M = block_tables.shape
    return pool[block_tables.long()].reshape(B, M * bs, n_kv, D)


def dequant_gather_block_kv(pool, scales, tail, block_tables, tail_base):
    """``gather_block_kv`` for the int8 pool (the reference's
    ``dequant_gather_block_kv``): the gathered pages times their scales in
    f32, table entries ``tail_base[b]`` and the next one overlaid by the
    row's two tail slots, cast once to the tail's dtype; [B, max_blocks
    * bs, n_kv, D]."""
    _, bs, n_kv, D = pool.shape
    B, M = block_tables.shape
    tbl = block_tables.long()
    deq = pool[tbl].float() * scales[tbl][:, :, None, :, None]
    rel = (torch.arange(M, device=pool.device)[None, :]
           - tail_base.long()[:, None])
    use_tail = (rel >= 0) & (rel < 2)
    tg = tail[torch.arange(B, device=pool.device)[:, None], rel.clamp(0, 1)]
    out = torch.where(use_tail[:, :, None, None, None], tg.float(), deq)
    return out.to(tail.dtype).reshape(B, M * bs, n_kv, D)


def _dense_decode(q, k, v, mask):
    """The routers' dense route: ``model.attention`` over the reference's
    mask, which the caller must pass (the route never derives one)."""
    if mask is None:
        raise ValueError(
            f"the decode routers' dense route needs the reference's mask: "
            f"q {tuple(q.shape)} over {tuple(k.shape)} fails the kernel's "
            f"guard on {q.device}")
    from kubeinfer_tpu_torch.inference.model import attention

    return attention(q, k, v, mask)


def decode_attention_auto(q, k, v, lengths, mask=None, gspmd=False):
    """Decode-step attention, the reference's router: #10
    (``decode_attention``) iff T == 1 and ``decode_flash_available(S, D)``
    holds on q's device, else the dense ``model.attention`` over ``mask``.
    ``lengths`` and ``mask`` must describe the same live set.

    ``gspmd=True`` pins the dense branch, as the reference's flag does
    for a caller tracing under a sharded jit (GSPMD cannot split a Pallas
    call over heads). The port's sharded engine calls every router per
    tp rank on plain local tensors with ``gspmd=False``, so the kernels
    run on each rank's heads."""
    if not gspmd and q.shape[1] == 1 and decode_flash_available(
            k.shape[1], q.shape[3], q.device):
        return decode_attention(q, k, v, lengths)
    return _dense_decode(q, k, v, mask)


def decode_attention_blocks_auto(q, k_pool, v_pool, block_tables, lengths,
                                 mask=None, gspmd=False):
    """Paged decode-step attention, the reference's router: #11
    (``decode_attention_blocks``, any T >= 1) iff
    ``decode_blocks_available(bs, D)`` holds on q's device, else the
    dense ``model.attention`` over ``mask`` on both pools gathered
    through the tables. ``mask`` must be s <= lengths[b] - T + t.
    ``gspmd=True`` pins the gather + dense branch (the reference's
    sharded route; see ``decode_attention_auto``)."""
    if not gspmd and decode_blocks_available(k_pool.shape[1], q.shape[3],
                                             q.device):
        return decode_attention_blocks(q, k_pool, v_pool, block_tables,
                                       lengths)
    return _dense_decode(q, gather_block_kv(k_pool, block_tables),
                         gather_block_kv(v_pool, block_tables), mask)


def decode_attention_blocks_q8_auto(q, k_pool, v_pool, k_scales, v_scales,
                                    k_tail, v_tail, block_tables, lengths,
                                    mask=None, gspmd=False):
    """Paged decode over the int8 pool, the reference's router: #12
    (``decode_attention_blocks_q8``) under #11's guard, else the dense
    ``model.attention`` over ``mask`` on ``dequant_gather_block_kv`` of
    both pools, with the tail base max(lengths - T, 0) // bs both routes
    derive. ``gspmd=True`` pins the dense branch (see
    ``decode_attention_auto``)."""
    bs = k_pool.shape[1]
    if not gspmd and decode_blocks_available(bs, q.shape[3], q.device):
        return decode_attention_blocks_q8(q, k_pool, v_pool, k_scales,
                                          v_scales, k_tail, v_tail,
                                          block_tables, lengths)
    tb = torch.clamp(lengths.long() - q.shape[1], min=0) // bs
    return _dense_decode(
        q, dequant_gather_block_kv(k_pool, k_scales, k_tail, block_tables, tb),
        dequant_gather_block_kv(v_pool, v_scales, v_tail, block_tables, tb),
        mask)


# --- the differentiable causal route (training) -------------------------------


def _check_diff_tiles(T, S, tile_t, tile_s):
    if T % tile_t or S % tile_s:
        raise ValueError(
            f"flash_attention_causal_diff needs T divisible by {tile_t} "
            f"and S by {tile_s}; got T={T} S={S} (use the dense path for "
            "unaligned shapes)"
        )


class FlashCausalDiff(torch.autograd.Function):
    """The reference's ``flash_attention_causal_diff`` custom_vjp under
    autograd: the forward is #13 (o and the per-row lse), the backward
    the two #14 kernels on the saved (q, k, v, o, lse), with drow =
    rowsum(dO * O) computed between them in torch. ``q_offset`` and
    ``row_lens`` get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, row_lens):
        o, lse = flash_ragged_lse(q, k, v, q_offset, row_lens)
        ctx.save_for_backward(q, k, v, o, lse, row_lens)
        ctx.q_offset = int(q_offset)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, row_lens = ctx.saved_tensors
        do = do.contiguous()  # autograd may hand in a strided gradient
        drow = flash_bwd_drow(o, do, k.shape[2])
        dq = flash_bwd_dq(q, k, v, do, lse, drow, ctx.q_offset, row_lens)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, drow, ctx.q_offset,
                               row_lens)
        return dq, dk, dv, None, None


def flash_attention_causal_diff(q, k, v, q_offset, row_lens):
    """Differentiable ragged-causal flash attention (the reference's
    ``flash_attention_causal_diff`` without its ``interpret`` switch).
    Under autograd (grad enabled and an input that requires it) it is
    ``FlashCausalDiff``; otherwise the primal, #9's
    ``flash_attention_ragged``, whose o #13 reproduces bitwise. T and S
    must divide by ``TILE_T`` and ``TILE_S`` (or be smaller), as in the
    reference."""
    T, S = q.shape[1], k.shape[1]
    _check_diff_tiles(T, S, min(TILE_T, T), min(TILE_S, S))
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashCausalDiff.apply(q, k, v, q_offset, row_lens)
    return flash_attention_ragged(q, k, v, q_offset, row_lens)


def flash_available(T: int, S: int, D: int, device) -> bool:
    """The reference's guard on the shapes its flash route takes, word for
    word, with its accelerator test read as "``device`` is CUDA": the
    kernels' tile alignment and the production head widths (64/128/256).
    Tiny test models (D = 16) and every CPU tensor take the dense path."""
    return (
        torch.device(device).type == "cuda"
        and T % 8 == 0
        and T % min(TILE_T, T) == 0
        and S % min(TILE_S, S) == 0
        and S % 128 == 0
        and T >= 8
        and S >= 128
        and D % 64 == 0
    )


def causal_attention_auto(q, k, v, mask):
    """Plain causal self-attention (T == S) with the mask derived
    in-kernel: ``model.forward``'s no-cache binding, so training and
    full-sequence prefill never build [T, T] scores where the flash route
    is available. ``mask`` is the dense fallback's operand and the flash
    branch does not read it. Differentiable through ``FlashCausalDiff``."""
    B, T = q.shape[0], q.shape[1]
    S, D = k.shape[1], q.shape[3]
    if T == S and flash_available(T, S, D, q.device):
        # filled on the device: torch.tensor would be a pageable copy
        # that synchronises the host
        lens = torch.full((B,), S, dtype=torch.int32, device=q.device)
        return flash_attention_causal_diff(q, k, v, 0, lens)
    from kubeinfer_tpu_torch.inference.model import attention

    return attention(q, k, v, mask)


def attention_auto(q, k, v, mask):
    """``model.attention``'s signature: #9b (``flash_attention``) where
    ``flash_available`` holds for (T, S, D) on q's device, the dense
    ``model.attention`` otherwise. The reference's drop-in for
    ``forward(attn_fn=...)``; every CPU tensor goes dense."""
    if flash_available(q.shape[1], k.shape[1], q.shape[3], q.device):
        # the kernel reads the mask's bytes in place: a broadcast view
        # (forward shares one mask across layers) is made whole first
        return flash_attention(q, k, v, mask.contiguous())
    from kubeinfer_tpu_torch.inference.model import attention

    return attention(q, k, v, mask)
