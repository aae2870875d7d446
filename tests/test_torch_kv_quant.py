"""The port's int8 KV pool against the JAX package's:
``quantize_blocks``/``dequantize_blocks`` BITWISE (a zero block gets
scale 1, requantize exact), ``decode_attention_blocks_q8_plain`` against
the reference's Pallas kernel (interpret mode) and its jnp twin over GQA
ratios, mixed lengths, T = 1 and T = 2 windows that spill into tail slot
1 and a row shorter than its window, and ``_commit_full_tails`` BITWISE
on seeded pools; on a card, kernel #12 against its plain version.

Tolerances: plain vs the reference 1e-6 in f32 and 2 bf16 ulps of the
row's largest |value| (2**-6 of it) in bf16, on rows with a live
position (len >= T); kernel vs plain on the card 1e-5 in f32 and 2**-6
of the row's magnitude in bf16, finite everywhere.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu.inference import kv_blocks as jkv
from kubeinfer_tpu.inference import stepper as jst
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import kv_blocks as tkv
from kubeinfer_tpu_torch.inference import stepper as tst
from kubeinfer_tpu_torch.inference.model import attention

BF16_REL = 2.0 ** -6


def t(a):
    return torch.from_numpy(np.array(a))


def to_np(x):
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def q8_inputs(B, T, n_kv, G, D, bs, M, lens, seed, dtype=np.float32):
    """Random int8 pages and scales with junk in every page, permuted
    null-padded tables, and tails independent of the pool."""
    rng = np.random.default_rng(seed)
    NB = 1 + B * M + 3
    q = rng.standard_normal((B, T, n_kv * G, D)).astype(np.float32)
    kp, vp = (rng.integers(-127, 128, (NB, bs, n_kv, D)).astype(np.int8)
              for _ in range(2))
    ks, vs = (np.exp(rng.standard_normal((NB, n_kv))).astype(np.float32)
              * np.float32(0.01) for _ in range(2))
    kt, vt = (rng.standard_normal((B, 2, bs, n_kv, D)).astype(np.float32)
              for _ in range(2))
    tbl = rng.permutation(np.arange(1, NB))[:B * M].reshape(B, M)
    tbl = np.ascontiguousarray(tbl, np.int32)
    for b, n in enumerate(lens):
        tbl[b, -(-n // bs):] = 0
    return q, kp, vp, ks, vs, kt, vt, tbl, np.asarray(lens, np.int32)


def pool_block(seed, shape=(3, 16, 2, 8)):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x[1] = 0.0  # an all-zero block: scale 1, codes 0
    x[2, :, 1] *= 1e3  # heads of different magnitude
    return x


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quantize_blocks_bitwise(dtype):
    x = pool_block(1)
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == "f32" else jnp.bfloat16)
    tx = t(x).to(torch.float32 if dtype == "f32" else torch.bfloat16)
    jq, js = jkv.quantize_blocks(jx)
    q, s = tkv.quantize_blocks(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert (s[1] == 1.0).all() and (q[1] == 0).all()
    for out in (None, torch.bfloat16):
        jd = None if out is None else jnp.bfloat16
        np.testing.assert_array_equal(
            to_np(tkv.dequantize_blocks(q, s, out)),
            np.asarray(jkv.dequantize_blocks(jq, js, jd), np.float32))
    # requantizing a dequantized block gives the same codes and scales
    q2, s2 = tkv.quantize_blocks(tkv.dequantize_blocks(q, s))
    assert torch.equal(q2, q) and torch.equal(s2, s)


def check(got, want, lens, T, dtype):
    live = np.asarray(lens) >= T
    g, w = to_np(got)[live], np.asarray(want, np.float32)[live]
    if dtype == "f32":
        np.testing.assert_allclose(g, w, atol=1e-6, rtol=0)
    else:
        mag = np.abs(w).reshape(len(w), -1).max(axis=1)
        err = np.abs(g - w).reshape(len(w), -1).max(axis=1)
        assert (err <= BF16_REL * mag).all(), (err, mag)
    assert np.isfinite(to_np(got)).all()


@pytest.mark.parametrize("G,n_kv", [(1, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_reference(G, n_kv, T, dtype):
    """Rows: mid-block, an exact block edge (T = 2 spills into tail slot
    1), the full table, a row shorter than the window, a retired row."""
    lens = [17, 16, 48, 1, 0]
    ins = q8_inputs(5, T, n_kv, G, 16, 16, 3, lens, 31 + G + T)
    q, kp, vp, ks, vs, kt, vt, tbl, ln = ins
    jd = jnp.float32 if dtype == "f32" else jnp.bfloat16
    td = torch.float32 if dtype == "f32" else torch.bfloat16
    jargs = (jnp.asarray(q).astype(jd), jnp.asarray(kp), jnp.asarray(vp),
             jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(kt).astype(jd),
             jnp.asarray(vt).astype(jd), jnp.asarray(tbl), jnp.asarray(ln))
    targs = (t(q).to(td), t(kp), t(vp), t(ks), t(vs), t(kt).to(td),
             t(vt).to(td), t(tbl), t(ln))
    got = tfa.decode_attention_blocks_q8_plain(*targs)
    assert got.dtype == td and got.shape == q.shape
    check(got, jfa.decode_attention_blocks_q8(*jargs, interpret=True), ln,
          T, dtype)
    check(got, jfa.decode_attention_blocks_q8_jnp(*jargs), ln, T, dtype)
    # on the CPU the wrapper takes the plain version, and the router the
    # dense route over the reference's mask on the dequantize-gathered
    # pools (tail base max(len - T, 0) // bs)
    before = tfa.decode_attention_blocks_q8.launches
    assert torch.equal(tfa.decode_attention_blocks_q8(*targs), got)
    mask = t(np.arange(3 * 16)[None, None, :]
             <= (ln - T)[:, None, None] + np.arange(T)[None, :, None])
    routed = tfa.decode_attention_blocks_q8_auto(*targs, mask)
    tb = t(np.maximum(ln - T, 0) // 16)
    assert torch.equal(routed, attention(
        targs[0],
        tfa.dequant_gather_block_kv(targs[1], targs[3], targs[5], t(tbl), tb),
        tfa.dequant_gather_block_kv(targs[2], targs[4], targs[6], t(tbl), tb),
        mask))
    assert tfa.decode_attention_blocks_q8.launches == before


def test_commit_full_tails_bitwise():
    """Two layers of K pools: a row that crosses (its tail slot 0 goes to
    its block, the tail shifts), one that does not, an inactive row whose
    offset would cross, and a retired row on the null block."""
    rng = np.random.default_rng(5)
    L, NB, bs, n_kv, D, B, M = 2, 9, 8, 2, 16, 4, 3
    pools = [rng.integers(-127, 128, (NB, bs, n_kv, D)).astype(np.int8)
             for _ in range(L)]
    scales = [rng.random((NB, n_kv)).astype(np.float32) for _ in range(L)]
    tails = [rng.standard_normal((B, 2, bs, n_kv, D)).astype(np.float32)
             for _ in range(L)]
    tails[0][0, 0, :, 1] = 0.0  # one all-zero (block, head)
    tbl = np.array([[3, 4, 0], [5, 6, 7], [1, 2, 0], [0, 0, 0]], np.int32)
    old = np.array([15, 9, 7, 0], np.int32)
    new = np.array([16, 10, 8, 1], np.int32)
    keep = np.array([True, True, False, True])
    want = jst._commit_full_tails(
        [jnp.asarray(p) for p in pools], [jnp.asarray(s) for s in scales],
        [jnp.asarray(x) for x in tails], jnp.asarray(tbl), jnp.asarray(old),
        jnp.asarray(new), jnp.asarray(keep), bs)
    P, S, Tl = t(np.stack(pools)), t(np.stack(scales)), t(np.stack(tails))
    tst._commit_full_tails(P, S, Tl, t(tbl), t(old), t(new), t(keep), bs)
    for got, ref in zip((P, S, Tl), want):
        np.testing.assert_array_equal(got.numpy(),
                                      np.stack([np.asarray(r) for r in ref]))
    assert not np.array_equal(P.numpy()[:, 4], np.stack(pools)[:, 4])


# --- on the card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128])
def test_kernel_matches_plain_on_card(dtype, D):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    dev = torch.device("cuda")
    for T, bs, lens in ((1, 128, [200, 128, 300, 1, 0]),
                        (2, 16, [17, 16, 48, 1, 0])):
        ins = q8_inputs(5, T, 2, 4, D, bs, 3, lens, D + T)
        args = [t(a).to(dev) for a in ins]
        for i in (0, 5, 6):
            args[i] = args[i].to(dtype)
        before = tfa.decode_attention_blocks_q8.launches
        got = tfa.decode_attention_blocks_q8(*args)
        want = tfa.decode_attention_blocks_q8_plain(*args)
        torch.cuda.synchronize()
        assert tfa.decode_attention_blocks_q8.launches == before + 1
        g, w = got.float().cpu(), want.float().cpu()
        assert torch.isfinite(g).all()
        live = torch.from_numpy(np.asarray(lens) >= T)
        err = (g - w).abs().reshape(5, -1).amax(dim=1)[live]
        mag = w.abs().reshape(5, -1).amax(dim=1)[live]
        if dtype == torch.float32:
            assert (err <= 1e-5).all(), err
        else:
            assert (err <= BF16_REL * mag).all(), (err, mag)
    # quantizing on the card gives the CPU's codes and scales bitwise
    x = t(pool_block(D))
    for got, want in zip(tkv.quantize_blocks(x.to(dev)),
                         tkv.quantize_blocks(x)):
        assert torch.equal(got.cpu(), want)
