"""The decode routers bind as the reference's do.

``decode_attention_auto`` takes #10 iff T == 1 and
``decode_flash_available(S, D)`` holds; ``decode_attention_blocks_auto``
and ``decode_attention_blocks_q8_auto`` take #11 and #12 iff
``decode_blocks_available(bs, D)`` holds; everywhere else all three take
the dense ``model.attention`` over the reference's mask (the paged ones
over the pools gathered, or dequantize-gathered, through the tables).

- Routing: over S in {100, 128, 640, 8192}, bs in {16, 128}, D in {16,
  64, 128} and T in {1, 5}, the reference's guards evaluated with
  ``jax.default_backend`` answering "tpu" and the port's with the device
  answered as CUDA; spies record the route taken and compute nothing.
- The stepper builds the reference's mask only where the guard fails:
  ``step_forward`` (linear caches and the pool) hands the router None on
  the kernel route. (``verify_window``'s dense route is held to the
  reference's by ``test_torch_spec_verify.py``.)
- Dense route: on the CPU every router equals the reference's router on
  the same seeded inputs (both dense), f32 within 1e-6 times each row's
  largest |value| where that passes 1, else 1e-6 (XLA and PyTorch sum
  the products in other orders: a few f32 ulps), bf16 within 2**-6 of each
  row's
  largest |value| (about 2 bf16 ulps), every row finite: a retired row, a
  row shorter than its window and a verify window that spills into tail
  slot 1 included.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu_torch.inference import config as tc
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import stepper as tst

from test_torch_kv_quant import q8_inputs

BF16_REL = 2.0 ** -6
S_GRID = (100, 128, 640, 8192)
BS_GRID = (16, 128)
D_GRID = (16, 64, 128)
T_GRID = (1, 5)


def t(a):
    return torch.from_numpy(np.asarray(a))


def ref_guard(monkeypatch, fn, *args):
    """The reference's guard as on its accelerator."""
    real = jax.default_backend
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    try:
        return fn(*args)
    finally:
        monkeypatch.setattr(jax, "default_backend", real)


@pytest.fixture
def spies(monkeypatch):
    """Every kernel wrapper and the dense attention replaced by a spy that
    records its route and returns zeros; the port's guards answered for a
    CUDA device."""
    routes = []

    def kernel(name):
        def run(q, *args):
            routes.append((name,))
            return torch.zeros_like(q)
        return run

    def dense(q, k, v, mask):
        routes.append(("dense", tuple(k.shape), tuple(mask.shape)))
        return torch.zeros_like(q)

    for name in ("decode_attention", "decode_attention_blocks",
                 "decode_attention_blocks_q8"):
        monkeypatch.setattr(tfa, name, kernel(name))
    monkeypatch.setattr(tm, "attention", dense)
    flash, blocks = tfa.decode_flash_available, tfa.decode_blocks_available
    monkeypatch.setattr(tfa, "decode_flash_available",
                        lambda S, D, dev: flash(S, D, "cuda"))
    monkeypatch.setattr(tfa, "decode_blocks_available",
                        lambda bs, D, dev: blocks(bs, D, "cuda"))
    return routes


def test_linear_router_binds_as_the_reference(monkeypatch, spies):
    seen = set()
    for S in S_GRID:
        for D in D_GRID:
            for T in T_GRID:
                q = torch.zeros((1, T, 2, D))
                k = torch.zeros((1, S, 1, D))
                mask = torch.ones((1, T, S), dtype=torch.bool)
                kernel = T == 1 and ref_guard(
                    monkeypatch, jfa.decode_flash_available, S, D)
                want = ("decode_attention",) if kernel else (
                    "dense", (1, S, 1, D), (1, T, S))
                spies.clear()
                tfa.decode_attention_auto(q, k, k, t([S]).int(), mask)
                assert spies == [want], (S, D, T, spies)
                seen.add(want[0])
    assert seen == {"decode_attention", "dense"}
    # S = 640 passes S % 128 but not S % min(TILE_S, S): dense in both
    assert not ref_guard(monkeypatch, jfa.decode_flash_available, 640, 128)


def test_paged_routers_bind_as_the_reference(monkeypatch, spies):
    seen = set()
    M, NB = 2, 3
    for bs in BS_GRID:
        for D in D_GRID:
            for T in T_GRID:
                kernel = ref_guard(monkeypatch, jfa.decode_blocks_available,
                                   bs, D)
                q = torch.zeros((1, T, 2, D))
                tbl = torch.tensor([[1, 2]], dtype=torch.int32)
                lens = torch.tensor([M * bs], dtype=torch.int32)
                mask = torch.ones((1, T, M * bs), dtype=torch.bool)
                dense = ("dense", (1, M * bs, 1, D), (1, T, M * bs))
                pool = torch.zeros((NB, bs, 1, D))
                spies.clear()
                tfa.decode_attention_blocks_auto(q, pool, pool, tbl, lens,
                                                 mask)
                assert spies == [("decode_attention_blocks",) if kernel
                                 else dense], (bs, D, T, spies)
                pages = torch.zeros((NB, bs, 1, D), dtype=torch.int8)
                scales = torch.ones((NB, 1))
                tail = torch.zeros((1, 2, bs, 1, D))
                spies.clear()
                tfa.decode_attention_blocks_q8_auto(
                    q, pages, pages, scales, scales, tail, tail, tbl, lens,
                    mask)
                assert spies == [("decode_attention_blocks_q8",) if kernel
                                 else dense], (bs, D, T, spies)
                seen.add(kernel)
    assert seen == {True, False}


def test_routers_refuse_what_they_cannot_route(spies):
    """A dense route reached without the mask raises (the router never
    guesses one); ``gspmd=True`` (the reference's sharded route) takes the
    dense branch on each router where the kernel's guard holds, and
    launches no kernel."""
    q, k = torch.zeros((1, 1, 2, 16)), torch.zeros((1, 64, 1, 16))
    with pytest.raises(ValueError, match="mask"):
        tfa.decode_attention_auto(q, k, k, t([5]).int())
    pages = torch.zeros((2, 16, 1, 16), dtype=torch.int8)
    tail = torch.zeros((1, 2, 16, 1, 16))
    args = (q, pages, pages, torch.ones((2, 1)), torch.ones((2, 1)), tail,
            tail, t([[1]]).int(), t([5]).int())
    with pytest.raises(ValueError, match="mask"):
        tfa.decode_attention_blocks_q8_auto(*args)
    assert spies == []
    # shapes every kernel's guard admits (bs 128, D 64)
    q, k = torch.zeros((1, 1, 2, 64)), torch.zeros((1, 128, 1, 64))
    pages = torch.zeros((2, 128, 1, 64), dtype=torch.int8)
    tail = torch.zeros((1, 2, 128, 1, 64))
    args = (q, pages, pages, torch.ones((2, 1)), torch.ones((2, 1)), tail,
            tail, t([[1]]).int(), t([5]).int())
    with pytest.raises(ValueError, match="mask"):
        tfa.decode_attention_blocks_q8_auto(*args, gspmd=True)
    mask = torch.ones((1, 1, 128), dtype=torch.bool)
    tfa.decode_attention_auto(q, k, k, t([5]).int(), mask, gspmd=True)
    tfa.decode_attention_blocks_auto(q, pages.float(), pages.float(),
                                     t([[1]]).int(), t([5]).int(), mask,
                                     gspmd=True)
    tfa.decode_attention_blocks_q8_auto(*args, mask, gspmd=True)
    assert spies == [("dense", (1, 128, 1, 64), (1, 1, 128))] * 3
    # without the flag the same calls take the kernels
    tfa.decode_attention_auto(q, k, k, t([5]).int(), mask)
    tfa.decode_attention_blocks_auto(q, pages.float(), pages.float(),
                                     t([[1]]).int(), t([5]).int(), mask)
    tfa.decode_attention_blocks_q8_auto(*args, mask)
    assert spies[3:] == [("decode_attention",), ("decode_attention_blocks",),
                         ("decode_attention_blocks_q8",)]


def _small_cfg(D):
    return dataclasses.replace(
        tc.PRESETS["tiny"], vocab_size=64, hidden_size=2 * D,
        intermediate_size=32, num_hidden_layers=1, num_attention_heads=2,
        num_key_value_heads=1, max_position_embeddings=1024)


@pytest.mark.parametrize("kernel", [True, False])
def test_stepper_builds_the_mask_only_for_the_dense_route(monkeypatch,
                                                          kernel):
    """``step_forward`` (linear caches and the pool) hands the router the
    reference's mask [B, 1, S] exactly where the guard fails, and None
    where the kernel route takes the call."""
    cfg = _small_cfg(64)
    params = tm.init_params(cfg, seed=1, dtype=torch.float32, device="cpu")
    got = []
    for name in ("decode_attention_auto", "decode_attention_blocks_auto"):
        def spy(q, *args):
            got.append(None if args[-1] is None else tuple(args[-1].shape))
            return torch.zeros_like(q)
        monkeypatch.setattr(tfa, name, spy)
    monkeypatch.setattr(tfa, "decode_flash_available",
                        lambda S, D, dev: kernel)
    monkeypatch.setattr(tfa, "decode_blocks_available",
                        lambda bs, D, dev: kernel)
    tok = torch.tensor([3, 4])
    off = torch.tensor([5, 9], dtype=torch.int32)
    caches = [(torch.zeros((2, 256, 1, 64)), torch.zeros((2, 256, 1, 64)))]
    tst.step_forward(params, cfg, tok, off, caches, 256)
    pools = [(torch.zeros((5, 128, 1, 64)), torch.zeros((5, 128, 1, 64)))]
    tbl = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    tst.step_forward(params, cfg, tok, off, pools, 256, block_tables=tbl)
    assert got == ([None, None] if kernel else [(2, 1, 256), (2, 1, 256)])


# --- the dense route on the CPU against the reference's router -------------


def _close(got, want, dtype):
    g = (got.float() if got.dtype == torch.bfloat16 else got).numpy()
    w = np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    B = g.shape[0]
    err = np.abs(g - w).reshape(B, -1).max(axis=1)
    mag = np.abs(w).reshape(B, -1).max(axis=1)
    if dtype == "f32":
        assert (err <= 1e-6 * np.maximum(mag, 1.0)).all(), (err, mag)
    else:
        assert (err <= BF16_REL * mag).all(), (err, mag)


def _types(dtype):
    return ((jnp.float32, torch.float32) if dtype == "f32"
            else (jnp.bfloat16, torch.bfloat16))


def _window_mask(lens, T, S):
    return (np.arange(S)[None, None, :]
            <= (lens - T)[:, None, None] + np.arange(T)[None, :, None])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_routes_match_the_reference(dtype):
    """#10's router (a retired row of length 0, a full row) and #11's at
    T = 5 (a retired row on the null block, a row shorter than its
    window, a shared prefix block), pools of 16 positions: both packages
    take the dense route."""
    jd, td = _types(dtype)
    rng = np.random.default_rng(11)
    S, D = 48, 16
    q = rng.standard_normal((4, 1, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((4, S, 2, D)).astype(np.float32)
            for _ in range(2))
    lens = np.array([48, 17, 0, 1], np.int32)
    mask = np.arange(S)[None, None, :] < lens[:, None, None]
    want = jfa.decode_attention_auto(
        jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
        jnp.asarray(lens), jnp.asarray(mask))
    got = tfa.decode_attention_auto(t(q).to(td), t(k).to(td), t(v).to(td),
                                    t(lens), t(mask))
    _close(got, want, dtype)

    T, bs, M, NB = 5, 16, 3, 9
    q = rng.standard_normal((4, T, 4, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((NB, bs, 2, D)).astype(np.float32)
              for _ in range(2))
    tbl = np.array([[1, 2, 3], [1, 4, 0], [0, 0, 0], [5, 0, 0]], np.int32)
    lens = np.array([40, 20, 0, 3], np.int32)
    mask = _window_mask(lens, T, M * bs)
    want = jfa.decode_attention_blocks_auto(
        jnp.asarray(q, jd), jnp.asarray(kp, jd), jnp.asarray(vp, jd),
        jnp.asarray(tbl), jnp.asarray(lens), jnp.asarray(mask))
    got = tfa.decode_attention_blocks_auto(
        t(q).to(td), t(kp).to(td), t(vp).to(td), t(tbl), t(lens), t(mask))
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_dense_q8_route_matches_the_reference(dtype):
    """#12's router at T = 5 over pages of 16: a window that spills into
    tail slot 1 (length 18: positions 13-17 cross the edge at 16), one
    inside a block, a full table, a row shorter than its window, a
    retired row; then the dequantize-gather alone, bitwise."""
    jd, td = _types(dtype)
    T, bs, M = 5, 16, 3
    lens = [18, 40, 48, 3, 0]
    q, kp, vp, ks, vs, kt, vt, tbl, ln = q8_inputs(5, T, 2, 2, 16, bs, M,
                                                   lens, 12)
    mask = _window_mask(ln, T, M * bs)
    want = jfa.decode_attention_blocks_q8_auto(
        jnp.asarray(q, jd), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(kt, jd),
        jnp.asarray(vt, jd), jnp.asarray(tbl), jnp.asarray(ln),
        jnp.asarray(mask))
    got = tfa.decode_attention_blocks_q8_auto(
        t(q).to(td), t(kp), t(vp), t(ks), t(vs), t(kt).to(td), t(vt).to(td),
        t(tbl), t(ln), t(mask))
    _close(got, want, dtype)
    tb = np.maximum(ln - T, 0) // bs
    assert tb[0] == 0 and (ln[0] - 1) // bs == 1  # the spill into slot 1
    view = jfa.dequant_gather_block_kv(
        jnp.asarray(kp), jnp.asarray(ks), jnp.asarray(kt, jd),
        jnp.asarray(tbl), jnp.asarray(tb))
    mine = tfa.dequant_gather_block_kv(t(kp), t(ks), t(kt).to(td), t(tbl),
                                       t(tb))
    assert mine.dtype == td
    np.testing.assert_array_equal(mine.float().numpy(),
                                  np.asarray(view, np.float32))
