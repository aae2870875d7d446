"""Kernel #9b (``flash_attention`` over a dense bool mask), its router
``attention_auto``, and the engine's prefill binding, against the JAX
package; on a card, the CUDA kernel against its plain version.

The JAX side runs ``flash_attention`` in interpret mode with tile_t=8 and
tile_s=16 (the port's ``flash_attention_plain`` takes the same tiles), on
the cases of ``tests/test_flash_attention.py::TestFlashParity``; the
same seeded numpy inputs go to both.

Tolerances:
- f32, plain vs interpreted Pallas: 1e-5 absolute (both fold the same
  tiles from the same state; the products sum in another order);
- bf16: 2 bf16 ulps of each row's magnitude (2**-6 of its largest
  |value|);
- kernel vs plain on the card: the same two rules (the kernel sums in
  another order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import config as jc
from kubeinfer_tpu.inference import engine as je
from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu.inference import model as jm
from kubeinfer_tpu_torch.inference import config as tc
from kubeinfer_tpu_torch.inference import engine as te
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.model import attention

BF16_REL = 2.0 ** -6
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(B, T, S, H, n_kv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T, H, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32))


def tril(B, T, S, k=0):
    return np.broadcast_to(np.tril(np.ones((T, S), bool), k=k)[None],
                           (B, T, S)).copy()


def ragged(B, T, S, c0, lens):
    pos = np.arange(S)
    q_pos = c0 + np.arange(T)
    return ((pos[None, None, :] <= q_pos[None, :, None])
            & (pos[None, None, :] < np.asarray(lens)[:, None, None]))


def held(got, want, dtype):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)
    else:
        g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
        err = np.abs(g - w).max(axis=1)
        assert (err <= BF16_REL * np.abs(w).max(axis=1)).all(), err.max()


def port(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device).to(DTYPES[dtype][1])
            for a in arrays]


# (B, T, S, H, n_kv, D, mask, dtype): TestFlashParity's cases, with the
# GQA fold at 8:2 and 8:1
CASES = {
    "causal_multi_tile": (2, 64, 64, 4, 4, 16, tril(2, 64, 64), "float32"),
    "gqa_8_2": (2, 16, 32, 8, 2, 16, tril(2, 16, 32, 16), "float32"),
    "gqa_8_1": (2, 16, 32, 8, 1, 16, tril(2, 16, 32, 16), "float32"),
    "ragged_cache": (3, 8, 48, 4, 2, 8, ragged(3, 8, 48, 40, [5, 48, 17]),
                     "float32"),
    "fully_masked": (1, 8, 16, 2, 2, 8, np.zeros((1, 8, 16), bool),
                     "float32"),
    "bf16": (1, 32, 32, 4, 2, 16, tril(1, 32, 32), "bfloat16"),
}


@pytest.fixture(scope="module")
def small_tiles():
    mp = pytest.MonkeyPatch()
    mp.setattr(tfa, "TILE_T", 8)
    mp.setattr(tfa, "TILE_S", 16)
    yield
    mp.undo()


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_reference(small_tiles, name):
    """``flash_attention_plain`` against the interpreted Pallas kernel;
    the wrapper takes the plain version for CPU tensors (no launch)."""
    B, T, S, H, n_kv, D, mask, dt = CASES[name]
    q, k, v = inputs(B, T, S, H, n_kv, D)
    jdt = DTYPES[dt][0]
    want = jfa.flash_attention(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)), jnp.asarray(mask),
        tile_t=8, tile_s=16, interpret=True)
    tq, tk, tv = port((q, k, v), dt)
    tm = torch.from_numpy(mask)
    got = tfa.flash_attention_plain(tq, tk, tv, tm, tile_t=8, tile_s=16)
    assert got.dtype == DTYPES[dt][1] and got.shape == tq.shape
    held(got.float().numpy(), jnp.asarray(want, jnp.float32), dt)
    n0 = tfa.flash_attention.launches
    assert torch.equal(tfa.flash_attention(tq, tk, tv, tm), got)
    assert tfa.flash_attention.launches == n0
    if name == "fully_masked":
        # every key tile folded: the uniform mean of v over all S keys,
        # the dense softmax's answer, neither zeros nor NaN
        mean = tv.mean(dim=1)  # [B, n_kv, D]
        G = H // n_kv
        want_mean = mean.repeat_interleave(G, dim=1)[:, None].expand_as(got)
        torch.testing.assert_close(got, want_mean, atol=1e-6, rtol=0)
        torch.testing.assert_close(got, attention(tq, tk, tv, tm),
                                   atol=1e-6, rtol=0)


def test_single_tile_equals_multi_tile():
    q, k, v = port(inputs(1, 32, 32, 4, 4, 8, seed=1), "float32")
    mask = torch.from_numpy(tril(1, 32, 32))
    one = tfa.flash_attention_plain(q, k, v, mask, tile_t=32, tile_s=32)
    many = tfa.flash_attention_plain(q, k, v, mask, tile_t=8, tile_s=8)
    torch.testing.assert_close(one, many, atol=2e-5, rtol=1e-4)


def test_rejects_unaligned():
    q, k, v = port(inputs(1, 24, 24, 2, 2, 8, seed=3), "float32")
    mask = torch.ones((1, 24, 24), dtype=torch.bool)
    with pytest.raises(ValueError, match="divisible.*attention_auto"):
        tfa.flash_attention_plain(q, k, v, mask, tile_t=16, tile_s=16)
    with pytest.raises(ValueError, match="unsupported device meta"):
        m = torch.empty((1, 24, 24), dtype=torch.bool, device="meta")
        e = torch.empty((1, 24, 2, 8), device="meta")
        tfa.flash_attention(e, e, e, m)


def test_attention_auto_goes_dense_on_the_cpu():
    """On the CPU ``attention_auto`` is ``model.attention`` (bitwise), and
    within 1e-6 of the reference's ``attention_auto`` on the CPU (both
    dense; XLA and PyTorch sum the f32 products in another order)."""
    q, k, v = inputs(1, 8, 16, 2, 2, 8, seed=2)
    mask = tril(1, 8, 16, 8)
    want = jfa.attention_auto(*(jnp.asarray(a) for a in (q, k, v)),
                              jnp.asarray(mask))
    tq, tk, tv = port((q, k, v), "float32")
    tm = torch.from_numpy(mask)
    n0 = tfa.flash_attention.launches
    got = tfa.attention_auto(tq, tk, tv, tm)
    assert tfa.flash_attention.launches == n0
    assert torch.equal(got, attention(tq, tk, tv, tm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


def test_attention_auto_routes_by_the_guard(monkeypatch):
    """Where the guard holds, the kernel wrapper with the mask made whole
    (a broadcast view, as forward shares one mask across layers)."""
    q, k, v = port(inputs(2, 8, 16, 2, 2, 8, seed=4), "float32")
    mask = torch.from_numpy(tril(1, 8, 16, 8)).expand(2, 8, 16)
    seen = []

    def spy(q_, k_, v_, m_):
        seen.append(m_.is_contiguous())
        return tfa.flash_attention_plain(q_, k_, v_, m_)

    monkeypatch.setattr(tfa, "flash_available", lambda *a: True)
    monkeypatch.setattr(tfa, "flash_attention", spy)
    tfa.attention_auto(q, k, v, mask)
    assert seen == [True]


def test_flash_available_matches_reference(monkeypatch):
    """The guard on the engine's prefill shapes: the reference on its
    accelerator (its backend patched to "tpu") against the port on a
    CUDA device."""
    table = [(C, S, D) for C in (4, 8, 16, 200, 512, 2048)
             for S in (128, 200, 256, 1024, 8192) for D in (16, 64, 128)]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = [jfa.flash_available(*s) for s in table]
    assert any(want) and not all(want)
    assert [tfa.flash_available(*s, "cuda") for s in table] == want


def _gate_model(D):
    kw = dict(vocab_size=64, hidden_size=2 * D, intermediate_size=32,
              num_hidden_layers=1, num_attention_heads=2,
              num_key_value_heads=1, max_position_embeddings=1024)
    jcfg, tcfg = jc.ModelConfig(**kw), tc.ModelConfig(**kw)
    p = jm.init_params(jcfg, jax.random.PRNGKey(D))
    return jcfg, tcfg, p, tw.params_from_reference(
        jax.tree.map(np.asarray, p), "cpu")


# (prompt bucket T, chunk, cache_len, D): C = min(T, chunk)
GATE = [(4, 4, 200, 16), (16, 8, 200, 64), (16, 16, 128, 16),
        (16, 8, 256, 64), (32, 16, 256, 128), (16, 4, 128, 64),
        (8, 8, 128, 128)]


def test_chunked_prefill_binds_as_the_reference(monkeypatch):
    """``chunked_prefill`` binds #9 (``prefill_attn``) iff the reference's
    ``use_flash = flash_available(C, cache_len, D)`` holds on its
    accelerator, and ``attention_auto`` over the dense mask elsewhere
    (the guard answered as on a card, the device left the CPU)."""
    real = tfa.flash_available
    monkeypatch.setattr(tfa, "flash_available",
                        lambda T, S, D, dev: real(T, S, D, "cuda"))
    routes = []
    real_prefill_attn = te.prefill_attn

    def spy_flash(c0, lens):
        routes.append("flash")
        return real_prefill_attn(c0, lens)

    def spy_dense(q, k, v, mask):
        routes.append("dense" if mask.shape == (q.shape[0], q.shape[1],
                                                k.shape[1]) else "bad")
        return attention(q, k, v, mask)

    monkeypatch.setattr(te, "prefill_attn", spy_flash)
    monkeypatch.setattr(tfa, "attention_auto", spy_dense)
    jp_backend = jax.default_backend
    for T, chunk, cache_len, D in GATE:
        jcfg, tcfg, _, tp = _gate_model(D)
        C = min(T, chunk)
        monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
        want = "flash" if jfa.flash_available(C, cache_len, D) else "dense"
        monkeypatch.setattr(jax, "default_backend", jp_backend)
        routes.clear()
        prompt = torch.ones((1, T), dtype=torch.int64)
        caches = te.make_caches(tcfg, 1, cache_len, torch.float32, "cpu")
        te.chunked_prefill(tp, prompt, torch.tensor([T], dtype=torch.int32),
                           tcfg, caches, chunk)
        assert set(routes) == {want}, (T, chunk, cache_len, D, routes)
    assert {"flash", "dense"} <= {
        "flash" if real(min(T, c), S, D, "cuda") else "dense"
        for T, c, S, D in GATE}


def test_chunked_prefill_dense_route_matches_reference():
    """On the CPU both packages take the dense route: next_logits of a
    ragged two-row prompt in two chunks, D = 16 and D = 64, within 1e-5
    (f32; the dense products sum in another order in XLA and PyTorch)."""
    for D in (16, 64):
        jcfg, tcfg, p, tp = _gate_model(D)
        prompt = np.zeros((2, 32), np.int32)
        prompt[0, :29] = np.arange(1, 30)
        prompt[1, :7] = [5, 6, 7, 8, 9, 10, 11]
        lens = np.array([29, 7], np.int32)
        _, want = je.chunked_prefill(
            p, jnp.asarray(prompt), jnp.asarray(lens), jcfg,
            je.make_caches(jcfg, 2, 128, jnp.float32), 16)
        _, got = te.chunked_prefill(
            tp, torch.from_numpy(prompt), torch.from_numpy(lens), tcfg,
            te.make_caches(tcfg, 2, 128, torch.float32, "cpu"), 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _held_card(got, want, live=None):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    rel = 1e-5 if got.dtype == torch.float32 else BF16_REL
    err = (g - w).abs().amax(dim=1)
    tol = rel if got.dtype == torch.float32 else rel * w.abs().amax(dim=1)
    assert bool((err <= tol).all()), float(err.max())


def packed_mask(T, docs, pad):
    """Block-diagonal causal over documents of the given lengths, then
    ``pad`` rows that see nothing."""
    m = np.zeros((T, T), bool)
    s = 0
    for n in docs:
        m[s:s + n, s:s + n] = np.tril(np.ones((n, n), bool))
        s += n
    assert s + pad == T
    return m


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
def test_kernel_matches_plain_on_card(dtype, D):
    """#9b against its plain version: a packed-document mask with padding
    rows (uniform means), a random mask, GQA 4:1, S a multiple of 16 (the
    16-byte mask loads) and S = 100 (the byte loads)."""
    dev = _card()
    rng = np.random.default_rng(D)
    for T, S, mask in (
            (256, 256, packed_mask(256, [64, 128, 48], 16)[None]),
            (64, 100, rng.random((2, 64, 100)) < 0.3)):
        B = mask.shape[0]
        q, k, v = (torch.from_numpy(a).to(dev).to(dtype) for a in inputs(
            B, T, S, 8, 2, D, seed=D + S))
        m = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
        n0 = tfa.flash_attention.launches
        got = tfa.flash_attention(q, k, v, m)
        want = tfa.flash_attention_plain(q, k, v, m)
        torch.cuda.synchronize()
        assert tfa.flash_attention.launches == n0 + 1
        _held_card(got, want)
        dead = ~m.any(dim=2)  # [B, T] rows that see nothing
        if bool(dead.any()):
            mean = v.float().mean(dim=1).repeat_interleave(4, dim=1)
            for b, t in dead.nonzero().tolist():
                _held_card(got[b, t], mean[b].to(dtype))


@pytest.mark.cuda
def test_masked_route_leaves_9_and_13_unchanged():
    """#9 still within tolerance of its plain version and #13's o bitwise
    #9's on the same inputs, from the same library that now also holds
    #9b."""
    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev).to(torch.bfloat16)
               for a in inputs(2, 96, 256, 8, 2, 128, seed=9))
    ln = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    o9 = tfa.flash_attention_ragged(q, k, v, 160, ln)
    o13, _ = tfa.flash_ragged_lse(q, k, v, 160, ln)
    torch.cuda.synchronize()
    assert torch.equal(o9, o13)
    _held_card(o9, tfa.flash_attention_ragged_plain(q, k, v, 160, ln))
