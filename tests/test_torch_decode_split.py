"""The split-K decode kernel (#10, #11: ``csrc/decode_split.cu``).

On the CPU: its plain split-and-combine mirror
(``decode_split_combine_plain``) against the JAX package's
``decode_attention`` and ``decode_attention_blocks`` run in interpret
mode, f32, atol 1e-6 (both fold the same positions; the mirror folds
splits of C and combines them, the reference folds tiles in order, so
the sums run in another order), over rows of length 0, shorter than the
window, inside one split, ending on a split edge and spanning every
split; and the live-split mirror (``decode_split_walk``) against a
count made position by position.

On a card (``cuda``): both kernels against their plain versions, f32
within 1e-5 and bf16 within 2**-6 of each live row's largest |value|,
every row finite; the kernel's own count of its live splits against
``decode_split_walk``; a verify window's rows bitwise the T = 1 steps;
the tickets left zero by one launch for the next; one launch counted per
call.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu_torch.inference import flash_attention as tfa

BF16_REL = 2.0 ** -6


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def linear_inputs(B, S, n_kv, G, D, seed, lengths):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, 1, n_kv * G, D), rand(rng, B, S, n_kv, D),
            rand(rng, B, S, n_kv, D), np.asarray(lengths, np.int32))


def paged_inputs(B, T, n_kv, G, D, bs, M, NB, seed, lengths):
    """Pools and null-padded tables (block 0 past each row's last block);
    row 1 shares row 0's first block (a shared prefix); a row of length
    0 has an all-null table (a retired row)."""
    rng = np.random.default_rng(seed)
    q = rand(rng, B, T, n_kv * G, D)
    kp, vp = rand(rng, NB, bs, n_kv, D), rand(rng, NB, bs, n_kv, D)
    tbl = np.zeros((B, M), np.int32)
    for b, n in enumerate(lengths):
        if n == 0:
            continue
        used = min(-(-n // bs), M)
        tbl[b, :used] = rng.choice(np.arange(1, NB), used, replace=False)
    if B > 1 and lengths[0] and lengths[1]:
        tbl[1, 0] = tbl[0, 0]
    return q, kp, vp, tbl, np.asarray(lengths, np.int32)


def gathered(kp, tbl):
    """[B, M * bs, n_kv, D]: a pool read through the tables, in order."""
    B, M = tbl.shape
    return kp[tbl.reshape(-1)].reshape(B, M * kp.shape[1], *kp.shape[2:])


# S = 32 in splits of C = 8: a row of 0, one inside split 0 (5), one
# ending on a split edge (16), one spanning every split (32), two ending
# inside later splits (13, 27)
LINEAR_LENS = [0, 5, 16, 32, 13, 27]


@pytest.mark.parametrize("G", [1, 4])
def test_split_combine_matches_decode_attention(G):
    q, k, v, lens = linear_inputs(6, 32, 2, G, 16, 10 + G, LINEAR_LENS)
    want = np.asarray(jfa.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        tile_s=16, interpret=True))
    got = tfa.decode_split_combine_plain(t(q), t(k), t(v), t(lens), 8)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # the row of length 0 is the uniform average of v over every position
    mean_v = v[0].mean(axis=0)  # [n_kv, D]
    np.testing.assert_allclose(
        got.numpy()[0, 0].reshape(2, G, 16), np.repeat(mean_v[:, None], G,
                                                        axis=1), atol=1e-6)


# bs = 4, M = 8 (32 positions) in splits of C = 8 (two pages): a retired
# row (length 0, all-null table), a row shorter than the window (2), one
# inside split 0 (6), one ending on a split edge (16), one spanning every
# split (32), one ending inside a later split (21)
PAGED_LENS = [16, 21, 0, 2, 6, 32]


@pytest.mark.parametrize("T", [1, 3, 5])
@pytest.mark.parametrize("G", [1, 4])
def test_split_combine_matches_decode_attention_blocks(T, G):
    q, kp, vp, tbl, lens = paged_inputs(6, T, 2, G, 16, 4, 8, 40,
                                        20 + 3 * T + G, PAGED_LENS)
    want = np.asarray(jfa.decode_attention_blocks(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), interpret=True))
    C = tfa.decode_split_size(4, True)
    assert C == tfa.DECODE_SPLIT_PAGED  # 32 pages of 4: one split
    for c in (8, 12, C):  # several splits, splits off the page, one split
        got = tfa.decode_split_combine_plain(
            t(q), t(gathered(kp, tbl)), t(gathered(vp, tbl)), t(lens), c)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


def test_split_combine_matches_plain_versions():
    """The mirror against the port's own plain versions (the wrappers'
    CPU route), at a long row in many splits."""
    q, k, v, lens = linear_inputs(3, 300, 2, 4, 32, 7, [300, 129, 0])
    got = tfa.decode_split_combine_plain(t(q), t(k), t(v), t(lens), 32)
    want = tfa.decode_attention(t(q), t(k), t(v), t(lens))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    q, kp, vp, tbl, lb = paged_inputs(3, 5, 2, 4, 32, 16, 10, 40, 8,
                                      [150, 3, 77])
    got = tfa.decode_split_combine_plain(
        t(q), t(gathered(kp, tbl)), t(gathered(vp, tbl)), t(lb),
        tfa.decode_split_size(16, True))
    want = tfa.decode_attention_blocks(t(q), t(kp), t(vp), t(tbl), t(lb))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


@pytest.mark.parametrize("T,S_total,C", [(1, 32, 8), (3, 32, 8), (5, 40, 16),
                                         (1, 4096, 128), (5, 4096, 128)])
def test_split_walk_matches_a_position_count(T, S_total, C):
    rng = np.random.default_rng(S_total + T)
    lens = np.concatenate([[0, 1, T - 1, T, C - 1, C, C + 1, S_total,
                            S_total + 9], rng.integers(0, S_total, 20)])
    lens = np.clip(lens, 0, None).astype(np.int32)
    got = tfa.decode_split_walk(t(lens), T, S_total, C)
    for b, n in enumerate(lens.tolist()):
        walked = range(S_total) if n < T else range(min(n, S_total))
        want = len({p // C for p in walked})
        assert int(got[b]) == want, (n, int(got[b]), want)
    assert got.dtype == torch.int64


def test_split_size_from_geometry():
    assert tfa.decode_split_size(8192, False) == 256
    assert tfa.decode_split_size(128, True) == 128
    assert tfa.decode_split_size(16, True) == 128
    assert tfa.decode_split_size(96, True) == 192
    assert tfa.decode_split_size(256, True) == 256


def test_wrappers_take_the_plain_version_on_the_cpu():
    """CPU tensors: the plain versions, no launch counted, no walk."""
    q, k, v, lens = linear_inputs(2, 16, 2, 2, 16, 3, [16, 0])
    n10, n11 = tfa.decode_attention.launches, tfa.decode_attention_blocks.launches
    np.testing.assert_array_equal(
        tfa.decode_attention(t(q), t(k), t(v), t(lens)).numpy(),
        tfa.decode_attention_plain(t(q), t(k), t(v), t(lens)).numpy())
    q, kp, vp, tbl, lb = paged_inputs(2, 3, 2, 2, 16, 4, 4, 9, 4, [9, 2])
    np.testing.assert_array_equal(
        tfa.decode_attention_blocks(t(q), t(kp), t(vp), t(tbl), t(lb)).numpy(),
        tfa.decode_attention_blocks_plain(t(q), t(kp), t(vp), t(tbl),
                                          t(lb)).numpy())
    assert tfa.decode_attention.launches == n10
    assert tfa.decode_attention_blocks.launches == n11
    assert tfa.decode_attention.walk_counter is None
    assert tfa.decode_attention_blocks.walk_counter is None


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _close(got, want, live):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    B = g.shape[0]
    row_err = (g - w).abs().reshape(B, -1).amax(dim=1)
    live = torch.as_tensor(live)
    if got.dtype == torch.float32:
        assert bool((row_err[live] <= 1e-5).all()), row_err
    else:
        row_mag = w.abs().reshape(B, -1).amax(dim=1)
        assert bool((row_err <= BF16_REL * row_mag)[live].all()), (
            row_err, row_mag)


def _walked(fn, wrapper, dev, *args):
    """(result, the kernel's own count of its live splits) of one call."""
    wrapper.walk_counter = torch.zeros(1, dtype=torch.int32, device=dev)
    try:
        out = fn(*args)
        torch.cuda.synchronize()
        return out, int(wrapper.walk_counter.item())
    finally:
        wrapper.walk_counter = None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_split_linear_matches_plain_on_card(dtype, D):
    """#10: a long row in many splits, one ending on a split edge, one of
    length 0 (every split, the uniform average), one inside a split."""
    dev = _card()
    S = 1000
    lens = np.asarray([1000, 256, 0, 77, 1], np.int32)
    q, k, v, _ = linear_inputs(5, S, 2, 4, D, D, lens)
    args = [t(a).to(dev).to(dtype) for a in (q, k, v)] + [t(lens).to(dev)]
    n = tfa.decode_attention.launches
    got, walked = _walked(tfa.decode_attention, tfa.decode_attention, dev,
                          *args)
    assert tfa.decode_attention.launches == n + 1
    C = tfa.decode_split_size(S, False)
    want_walk = 2 * int(tfa.decode_split_walk(t(lens), 1, S, C).sum())
    assert walked == want_walk
    # every row, the one of length 0 (the uniform average) included
    _close(got, tfa.decode_attention_plain(*args), lens >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
@pytest.mark.parametrize("T", [1, 3, 5])
def test_split_paged_matches_plain_on_card(dtype, D, T):
    """#11: pages of 16 (C = 8 pages) and of 128 (C = 1 page); a retired
    row (all-null table), a row shorter than the window, rows ending on
    and inside a split, a shared prefix block."""
    dev = _card()
    for bs, M in ((16, 40), (128, 6)):
        lens = [M * bs, 2 * 128, 0, T - 1, 77, 129]
        q, kp, vp, tbl, lb = paged_inputs(6, T, 2, 4, D, bs, M, 6 * M + 1,
                                          D + T + bs, lens)
        args = [t(a).to(dev).to(dtype) for a in (q, kp, vp)]
        args += [t(tbl).to(dev), t(lb).to(dev)]
        n = tfa.decode_attention_blocks.launches
        got, walked = _walked(tfa.decode_attention_blocks,
                              tfa.decode_attention_blocks, dev, *args)
        assert tfa.decode_attention_blocks.launches == n + 1
        C = tfa.decode_split_size(bs, True)
        assert walked == 2 * tfa.decode_row_blocks(4 * T, dtype) * int(
            tfa.decode_split_walk(t(lb), T, M * bs, C).sum())
        want = tfa.decode_attention_blocks_plain(*args)
        _close(got, want, lb >= T)
        if T > 1:  # the short row's defined output holds too
            _close(got, want, lb >= 0)


@pytest.mark.cuda
def test_split_many_rows_and_odd_widths_on_card():
    """Past a block's rows (T = 5, G = 16 in bf16 and G = 8 in f32: a
    second row block), f32 at D 144 (two chunks a lane, idle lanes), bf16
    at D 48 and 144 (k-steps and n-tiles past D skipped), a lone row."""
    dev = _card()
    cases = ((5, 16, 128, torch.bfloat16), (5, 8, 144, torch.float32),
             (3, 4, 48, torch.bfloat16), (1, 1, 144, torch.float32),
             (5, 8, 144, torch.bfloat16))
    for T, G, D, dtype in cases:
        lens = [300, 2 * 128, 0, T - 1 if T > 1 else 1]
        q, kp, vp, tbl, lb = paged_inputs(4, T, 2, G, D, 32, 12, 49, D + G,
                                          lens)
        args = [t(a).to(dev).to(dtype) for a in (q, kp, vp)]
        args += [t(tbl).to(dev), t(lb).to(dev)]
        got, walked = _walked(tfa.decode_attention_blocks,
                              tfa.decode_attention_blocks, dev, *args)
        rb = tfa.decode_row_blocks(T * G, dtype)
        assert walked == 2 * rb * int(tfa.decode_split_walk(
            t(lb), T, 12 * 32, tfa.decode_split_size(32, True)).sum())
        _close(got, tfa.decode_attention_blocks_plain(*args), lb >= 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_window_rows_equal_single_steps_on_card(dtype):
    """A verify window's query t (T = 5) equals the T = 1 call at its
    length bitwise: a row's arithmetic does not depend on the other rows
    of its block, and windows cross split edges (129, 255 + 5)."""
    dev = _card()
    T, bs, M = 5, 128, 6
    lens = [4 + 129, 300, 255 + 5, 600, 700]
    q, kp, vp, tbl, lb = paged_inputs(5, T, 2, 4, 128, bs, M, 31, 99, lens)
    q, kp, vp = (t(a).to(dev).to(dtype) for a in (q, kp, vp))
    tbl, lb = t(tbl).to(dev), t(lb).to(dev)
    window = tfa.decode_attention_blocks(q, kp, vp, tbl, lb)
    for step in range(T):
        one = tfa.decode_attention_blocks(
            q[:, step:step + 1].contiguous(), kp, vp, tbl,
            (lb - T + step + 1).to(torch.int32))
        torch.cuda.synchronize()
        assert torch.equal(window[:, step:step + 1], one), step


@pytest.mark.cuda
def test_split_tickets_reset_between_calls_on_card():
    """Two calls in a row on one stream share the ticket buffer: the
    second is right (each launch's last blocks left their tickets at 0)
    and equal to the first; the buffer is zero after both."""
    dev = _card()
    lens = np.asarray([4101, 900, 3000], np.int32)
    q, k, v, _ = linear_inputs(3, 4352, 8, 4, 128, 5, lens)
    args = [t(a).to(dev).to(torch.bfloat16) for a in (q, k, v)]
    args.append(t(lens).to(dev))
    first = tfa.decode_attention(*args)
    second = tfa.decode_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _close(second, tfa.decode_attention_plain(*args), lens > 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    assert int(tfa._tickets[(args[0].device, stream)].abs().sum()) == 0
