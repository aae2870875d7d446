"""The port's attention plain versions against the JAX package's Pallas
kernels (run in interpret mode on the CPU), and, on a card, the CUDA
kernels against their plain versions.

Same seeded numpy inputs on both sides. Tolerances: plain vs the
interpreted Pallas kernel 1e-6 (f32; both fold the same tiles, the
matmuls sum in another order); kernel vs plain on the card 1e-5 in f32,
and in bf16 at most 2 bf16 ulps of the row's magnitude (2**-6 of its
largest |value|) on every live row, finite on every row.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu_torch import _build
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference.model import attention

BF16_REL = 2.0 ** -6


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def decode_inputs(B, S, n_kv, G, D, seed, lengths):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, 1, n_kv * G, D), rand(rng, B, S, n_kv, D),
            rand(rng, B, S, n_kv, D), np.asarray(lengths, np.int32))


def paged_inputs(B, T, n_kv, G, D, bs, M, NB, seed, lengths):
    """Pools with shared blocks between rows, null-padded tables (block 0
    past each row's last block) and the given lengths."""
    rng = np.random.default_rng(seed)
    q = rand(rng, B, T, n_kv * G, D)
    kp, vp = rand(rng, NB, bs, n_kv, D), rand(rng, NB, bs, n_kv, D)
    tbl = np.zeros((B, M), np.int32)
    for b, n in enumerate(lengths):
        used = max(-(-n // bs), 1)
        tbl[b, :used] = rng.choice(np.arange(1, NB), used, replace=False)
    if B > 1:
        tbl[1, 0] = tbl[0, 0]  # a shared prefix block
    return q, kp, vp, tbl, np.asarray(lengths, np.int32)


def ragged_inputs(B, T, S, n_kv, G, D, seed):
    rng = np.random.default_rng(seed)
    return (rand(rng, B, T, n_kv * G, D), rand(rng, B, S, n_kv, D),
            rand(rng, B, S, n_kv, D))


@pytest.mark.parametrize("G", [1, 2, 4])
def test_decode_plain_matches_pallas(G):
    q, k, v, lens = decode_inputs(4, 64, 2, G, 16, G, [64, 17, 0, 1])
    want = np.asarray(jfa.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        tile_s=16, interpret=True))
    got = tfa.decode_attention_plain(t(q), t(k), t(v), t(lens), tile_s=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # on the CPU the wrapper takes the plain version, and the router the
    # dense route over the reference's mask
    before = tfa.decode_attention.launches
    np.testing.assert_array_equal(
        tfa.decode_attention(t(q), t(k), t(v), t(lens)).numpy(),
        tfa.decode_attention_plain(t(q), t(k), t(v), t(lens)).numpy())
    mask = t(np.arange(64)[None, None, :] < lens[:, None, None])
    np.testing.assert_array_equal(
        tfa.decode_attention_auto(t(q), t(k), t(v), t(lens), mask).numpy(),
        attention(t(q), t(k), t(v), mask).numpy())
    assert tfa.decode_attention.launches == before


@pytest.mark.parametrize("T,G", [(1, 1), (1, 4), (3, 2), (3, 4)])
def test_decode_blocks_plain_matches_pallas(T, G):
    """Rows: a long live row, one sharing its first block, a retired row
    (length 0, all-null table) and a row shorter than the window."""
    lens = [45, 20, 0, 2]
    q, kp, vp, tbl, lens = paged_inputs(4, T, 2, G, 16, 16, 4, 12, T + G,
                                        lens)
    tbl[2] = 0
    want = np.asarray(jfa.decode_attention_blocks(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(tbl),
        jnp.asarray(lens), interpret=True))
    got = tfa.decode_attention_blocks_plain(t(q), t(kp), t(vp), t(tbl),
                                            t(lens))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # on the CPU the router takes the dense route over the reference's
    # mask, on both pools gathered through the tables
    before = tfa.decode_attention_blocks.launches
    mask = t(np.arange(4 * 16)[None, None, :]
             <= (lens - T)[:, None, None] + np.arange(T)[None, :, None])
    routed = tfa.decode_attention_blocks_auto(t(q), t(kp), t(vp), t(tbl),
                                              t(lens), mask)
    np.testing.assert_array_equal(routed.numpy(), attention(
        t(q), tfa.gather_block_kv(t(kp), t(tbl)),
        tfa.gather_block_kv(t(vp), t(tbl)), mask).numpy())
    assert tfa.decode_attention_blocks.launches == before


@pytest.mark.parametrize("q_offset,G", [(0, 1), (0, 2), (16, 4), (40, 2)])
def test_ragged_plain_matches_pallas(q_offset, G):
    """Row 1 has row_len 0 (its defined output is the uniform average
    over every key); row 2 is shorter than the chunk."""
    B, T, S = 3, 16, 64
    q, k, v = ragged_inputs(B, T, S, 2, G, 16, q_offset + G)
    lens = np.asarray([S, 0, q_offset + 5], np.int32)
    want = np.asarray(jfa.flash_attention_ragged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset,
        jnp.asarray(lens), tile_t=8, tile_s=16, interpret=True))
    got = tfa.flash_attention_ragged_plain(t(q), t(k), t(v), q_offset,
                                           t(lens), tile_s=16)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    before = tfa.flash_attention_ragged.launches
    np.testing.assert_array_equal(
        tfa.flash_attention_ragged(t(q), t(k), t(v), q_offset,
                                   t(lens)).numpy(),
        tfa.flash_attention_ragged_plain(t(q), t(k), t(v), q_offset,
                                         t(lens)).numpy())
    assert tfa.flash_attention_ragged.launches == before


def test_fold_tile_math_matches_reference():
    rng = np.random.default_rng(3)
    G, Tq, Sk, D = 2, 3, 8, 16
    q, k, v = rand(rng, Tq * G, D), rand(rng, Sk, D), rand(rng, Sk, D)
    pen = np.where(rng.random((Tq, Sk)) < 0.3, -1e30, 0.0).astype(np.float32)
    m = rand(rng, Tq * G, 1)
    l = np.abs(rand(rng, Tq * G, 1))
    acc = rand(rng, Tq * G, D)
    want = jfa._fold_tile_math(*(jnp.asarray(a) for a in (q, k, v, pen, m, l,
                                                         acc)),
                               groups=G, scale=0.25)
    got = tfa.fold_tile_math(*(t(a)[None] for a in (q, k, v, pen, m, l, acc)),
                             groups=G, scale=0.25)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[0].numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def test_no_fallback_off_the_cpu(monkeypatch):
    """A tensor off the CPU goes to the kernel loader, never to the plain
    version; a missing nvcc raises."""
    q = torch.empty((1, 1, 2, 16), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfa.decode_attention(q, q, q, lens)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfa.flash_attention_ragged(q, q, q, 0, lens)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    with pytest.raises(_build.KernelBuildError):
        _build.build_all(["decode_attention"])


# --- on the card -------------------------------------------------------------


def _close(got: torch.Tensor, want: torch.Tensor, live: np.ndarray) -> float:
    """Assert the stated tolerance; return the largest |kernel - plain|."""
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    err = (g - w).abs()
    if got.dtype == torch.float32:
        assert float(err[torch.from_numpy(live)].max()) <= 1e-5
    else:
        B = g.shape[0]
        row_err = err.reshape(B, -1).amax(dim=1)
        row_mag = w.abs().reshape(B, -1).amax(dim=1)
        ok = row_err <= BF16_REL * row_mag
        assert bool(ok[torch.from_numpy(live)].all()), (row_err, row_mag)
    return float(err.max())


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_decode_kernels_match_plain_on_card(dtype, D):
    dev = _card()
    q, k, v, lens = decode_inputs(4, 300, 2, 4, D, D, [300, 77, 0, 1])
    args = [t(a).to(dev) for a in (q, k, v)]
    args = [a.to(dtype) for a in args] + [t(lens).to(dev)]
    before = tfa.decode_attention.launches
    got = tfa.decode_attention(*args)
    want = tfa.decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert tfa.decode_attention.launches == before + 1
    _close(got, want, lens > 0)
    for T in (1, 3):
        lens_b = [200, 130, 0, 2]
        q, kp, vp, tbl, lb = paged_inputs(4, T, 2, 4, D, 128, 3, 9, D + T,
                                          lens_b)
        tbl[2] = 0
        args = [t(a).to(dev).to(dtype) for a in (q, kp, vp)]
        args += [t(tbl).to(dev), t(lb).to(dev)]
        got = tfa.decode_attention_blocks(*args)
        want = tfa.decode_attention_blocks_plain(*args)
        torch.cuda.synchronize()
        _close(got, want, lb >= T)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_prefill_kernel_matches_plain_on_card(dtype, D):
    dev = _card()
    B, T, S = 3, 96, 256
    for q_offset in (0, 160):
        q, k, v = ragged_inputs(B, T, S, 2, 4, D, D + q_offset)
        lens = np.asarray([S, 0, q_offset + 37], np.int32)
        args = [t(a).to(dev).to(dtype) for a in (q, k, v)]
        before = tfa.flash_attention_ragged.launches
        got = tfa.flash_attention_ragged(*args, q_offset, t(lens).to(dev))
        want = tfa.flash_attention_ragged_plain(*args, q_offset,
                                                t(lens).to(dev))
        torch.cuda.synchronize()
        assert tfa.flash_attention_ragged.launches == before + 1
        _close(got, want, lens >= 0)
