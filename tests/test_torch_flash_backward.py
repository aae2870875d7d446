"""The port's differentiable flash attention (#13, #14) against the JAX
package's custom_vjp, and, on a card, the CUDA kernels against their
plain versions.

On both sides ``TILE_T``/``TILE_S`` are 8/16 and the JAX side runs its
Pallas kernels in interpret mode, on the cases of
``tests/test_flash_attention.py::TestFlashBackward``; the same seeded
numpy inputs go to both. The JAX results are computed once per module.

Tolerances:
- f32, plain vs interpreted Pallas: 1e-5 absolute (both fold the same
  tiles; the matmuls sum in another order);
- bf16: 2 bf16 ulps of each row's magnitude (2**-6 of its largest
  |value|): the products round to bf16 at the same places, but an f32
  sum in another order can move an output or a rounded dS by one ulp;
- rows with row_len == 0: exactly zero gradients;
- kernel vs plain on the card: 1e-5 (f32) or 2**-6 (bf16) of each
  row's magnitude, at least 1 (the kernels sum in another order);
  #13's o bitwise equal to #9's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu_torch.inference import flash_attention as tfa

BF16_REL = 2.0 ** -6
CASES = {
    "multi_tile": (2, 32, 4, 4, 16, [32, 20], "float32"),
    "gqa": (1, 32, 4, 2, 16, [25], "float32"),
    "bf16": (1, 32, 2, 2, 16, [32], "bfloat16"),
    "empty_row": (2, 32, 4, 4, 16, [20, 0], "float32"),
}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def inputs(B, T, H, n_kv, D, lens, seed=3):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, n_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, T, n_kv, D)).astype(np.float32)
    w = rng.standard_normal((B, T, H, D)).astype(np.float32)
    return q, k, v, w, np.asarray(lens, np.int32)


def to_np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def t(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.fixture(scope="module")
def small_tiles():
    mp = pytest.MonkeyPatch()
    for mod in (jfa, tfa):
        mp.setattr(mod, "TILE_T", 8)
        mp.setattr(mod, "TILE_S", 16)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def reference(small_tiles):
    """Per case: the inputs, the reference's #13 (o, lse), its #14 on
    those residuals with dO = w in the input dtype, and jax.grad of
    sum(o * w) through flash_attention_causal_diff (the same backward,
    reached through the custom_vjp)."""
    out = {}
    for name, (B, T, H, n_kv, D, lens, dt) in CASES.items():
        q, k, v, w, ln = inputs(B, T, H, n_kv, D, lens)
        jq, jk, jv = (jnp.asarray(a).astype(dt) for a in (q, k, v))
        jl = jnp.asarray(ln)
        o, res = jfa._diff_fwd(True, jq, jk, jv, 0, jl)
        do = jnp.asarray(w).astype(dt)
        bwd = jfa._diff_bwd(True, res, do)[:3]

        def loss(q_, k_, v_):
            o_ = jfa.flash_attention_causal_diff(True, q_, k_, v_, 0, jl)
            return jnp.sum(o_.astype(jnp.float32) * jnp.asarray(w))

        grads = (jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
                 if name in ("gqa", "bf16") else None)
        out[name] = dict(
            inputs=(q, k, v, w, ln), o=to_np(o), o_folded=to_np(res[5]),
            lse=to_np(res[6]), bwd=[to_np(g) for g in bwd],
            grads=None if grads is None else [to_np(g) for g in grads])
    return out


def assert_close(got, want, dtype, msg=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all(), msg
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=msg)
        return
    g, w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    err = np.abs(g - w).max(axis=1)
    mag = np.abs(w).max(axis=1)
    assert (err <= BF16_REL * mag + 1e-30).all(), (msg, err.max())


def port_inputs(case, dtype):
    q, k, v, w, ln = case["inputs"]
    return (t(q, dtype), t(k, dtype), t(v, dtype), t(w, torch.float32),
            torch.from_numpy(ln))


@pytest.mark.parametrize("name", list(CASES))
def test_lse_forward_matches_reference(reference, name):
    """#13's plain version: o and lse against the interpreted
    ``_diff_fwd``; its o bitwise #9's plain version (the same fold)."""
    case, dtype = reference[name], TORCH_DTYPE[CASES[name][6]]
    q, k, v, _, ln = port_inputs(case, dtype)
    o, lse = tfa.flash_ragged_lse_plain(q, k, v, 0, ln)
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert_close(o.float().numpy(), case["o"], dtype, "o")
    live = np.repeat(case["inputs"][4] > 0, lse.shape[0] // len(ln))
    np.testing.assert_allclose(lse.numpy()[live], case["lse"][live],
                               atol=1e-5, rtol=0)
    assert torch.equal(o, tfa.flash_attention_ragged_plain(q, k, v, 0, ln))
    # the wrapper takes the plain version for CPU tensors
    before = tfa.flash_ragged_lse.launches
    o2, lse2 = tfa.flash_ragged_lse(q, k, v, 0, ln)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)
    assert tfa.flash_ragged_lse.launches == before


@pytest.mark.parametrize("name", list(CASES))
def test_backward_matches_reference(reference, name):
    """#14's plain version on the reference's own residuals (o folded and
    lse from ``_diff_fwd``) against the interpreted ``_diff_bwd``."""
    case, dtype = reference[name], TORCH_DTYPE[CASES[name][6]]
    q, k, v, w, ln = port_inputs(case, dtype)
    do = w.to(dtype)
    o_f = t(case["o_folded"], dtype)
    lse = torch.from_numpy(np.array(case["lse"]))
    got = tfa.flash_bwd_plain(q, k, v, 0, ln, o_f, lse, do)
    for g, want, what in zip(got, case["bwd"], ("dq", "dk", "dv")):
        assert g.dtype == dtype
        assert_close(g.float().numpy(), want, dtype, what)
    # the wrappers take the plain versions for CPU tensors
    counts = (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)
    drow = (tfa._fold_q(do, k.shape[2]).float() * o_f.float()).sum(
        -1, keepdim=True)
    assert torch.equal(tfa.flash_bwd_dq(q, k, v, do, lse, drow, 0, ln),
                       got[0])
    dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, drow, 0, ln)
    assert torch.equal(dk, got[1]) and torch.equal(dv, got[2])
    assert counts == (tfa.flash_bwd_dq.launches, tfa.flash_bwd_dkv.launches)


@pytest.mark.parametrize("name", list(CASES))
def test_autograd_matches_reference(reference, name):
    """``FlashCausalDiff`` under autograd against the reference's custom
    vjp (jax.grad where computed, else its fwd/bwd pair), and exact zero
    gradients on rows with row_len == 0."""
    case, dtype = reference[name], TORCH_DTYPE[CASES[name][6]]
    q, k, v, w, ln = port_inputs(case, dtype)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention_causal_diff(*leaves, 0, ln)
    assert o.grad_fn is not None and "FlashCausalDiff" in type(
        o.grad_fn).__name__
    grads = torch.autograd.grad((o.float() * w).sum(), leaves)
    want = case["grads"] or case["bwd"]
    for g, wnt, what in zip(grads, want, ("dq", "dk", "dv")):
        assert_close(g.float().numpy(), wnt, dtype, what)
    for b, n in enumerate(case["inputs"][4]):
        if n == 0:
            for g in grads:
                assert torch.count_nonzero(g[b]) == 0
    # without autograd the primal is #9's wrapper, bitwise #13's o
    with torch.no_grad():
        primal = tfa.flash_attention_causal_diff(q, k, v, 0, ln)
    assert torch.equal(primal, o.detach())
    with pytest.raises(ValueError, match="divisible"):
        tfa.flash_attention_causal_diff(q[:, :12], k[:, :12], v[:, :12], 0,
                                        ln)


def test_flash_available_matches_reference(monkeypatch):
    """The guard word for word: the reference on its accelerator (its
    backend patched to "tpu") against the port on a CUDA device, and
    both off it."""
    table = [(T, S, D) for T in (4, 8, 12, 256, 512, 768, 2048)
             for S in (64, 128, 384, 512, 1024, 2048) for D in (16, 64, 96,
                                                                128, 256)]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    want = [jfa.flash_available(*s) for s in table]
    assert any(want) and not all(want)
    assert [tfa.flash_available(*s, "cuda") for s in table] == want
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    assert not any(jfa.flash_available(*s) for s in table)
    assert not any(tfa.flash_available(*s, "cpu") for s in table)


def test_causal_auto_routes(monkeypatch, small_tiles):
    """Dense on the CPU (bitwise ``model.attention``); where the guard
    holds, the differentiable flash route with full row lengths."""
    from kubeinfer_tpu_torch.inference.model import attention, causal_mask

    q, k, v, _, _ = port_inputs({"inputs": inputs(2, 32, 4, 2, 64, [32, 32])},
                                torch.float32)
    mask = causal_mask(32)[None].expand(2, 32, 32)
    assert torch.equal(tfa.causal_attention_auto(q, k, v, mask),
                       attention(q, k, v, mask))
    seen = []

    def spy(q_, k_, v_, off, lens):
        seen.append((off, lens.tolist(), lens.dtype))
        return tfa.flash_attention_ragged_plain(q_, k_, v_, off, lens)

    monkeypatch.setattr(tfa, "flash_available", lambda *a: True)
    monkeypatch.setattr(tfa, "flash_attention_causal_diff", spy)
    tfa.causal_attention_auto(q, k, v, mask)
    assert seen == [(0, [32, 32], torch.int32)]


def test_no_fallback_off_the_cpu():
    q = torch.empty((1, 16, 2, 64), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    lse = torch.empty((2, 16, 1), device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfa.flash_ragged_lse(q, q, q, 0, lens)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfa.flash_bwd_dq(q, q, q, q, lse, lse, 0, lens)
    with pytest.raises(ValueError, match="unsupported device meta"):
        tfa.flash_bwd_dkv(q, q, q, q, lse, lse, 0, lens)


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _held(got, want, live_rows=None):
    """Kernel vs plain: finite, and on the rows given (all by default)
    within 1e-5 (f32) or 2**-6 (bf16) of each row's magnitude, at least
    1: a gradient row sums up to T * G products in another order."""
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    if live_rows is not None:
        g, w = g[live_rows], w[live_rows]
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    rel = 1e-5 if got.dtype == torch.float32 else BF16_REL
    err = (g - w).abs().amax(dim=1)
    assert bool((err <= rel * w.abs().amax(dim=1).clamp(min=1.0)).all()), \
        float(err.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 64, 128, 256])
def test_kernels_match_plain_on_card(dtype, D):
    """#13 (o bitwise #9's, lse) and #14 (dQ, dK/dV) against their plain
    versions on ragged rows (one empty), GQA, unaligned T and S, and a
    query offset."""
    dev = _card()
    B, T, S, n_kv, G = 3, 96, 256, 2, 4
    for q_offset in (0, 160):
        rng = np.random.default_rng(D + q_offset)
        lens = np.asarray([S, 0, q_offset + 37], np.int32)
        shapes = ((B, T, n_kv * G, D), (B, S, n_kv, D), (B, S, n_kv, D),
                  (B, T, n_kv * G, D))
        q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
            np.float32)).to(dev).to(dtype) for s in shapes)
        ln = torch.from_numpy(lens).to(dev)
        n0 = (tfa.flash_ragged_lse.launches, tfa.flash_bwd_dq.launches,
              tfa.flash_bwd_dkv.launches)
        o, lse = tfa.flash_ragged_lse(q, k, v, q_offset, ln)
        o_p, lse_p = tfa.flash_ragged_lse_plain(q, k, v, q_offset, ln)
        o9 = tfa.flash_attention_ragged(q, k, v, q_offset, ln)
        torch.cuda.synchronize()
        assert torch.equal(o, o9)
        _held(o, o_p, torch.from_numpy(lens > 0))
        live = torch.from_numpy(np.repeat(lens > 0, n_kv))
        assert float((lse - lse_p).abs()[live.to(dev)].max()) <= 1e-4
        drow = tfa.flash_bwd_drow(o, do, n_kv)
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, drow, q_offset, ln)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, drow, q_offset, ln)
        dq_p = tfa.flash_bwd_dq_plain(q, k, v, do, lse, drow, q_offset, ln)
        dk_p, dv_p = tfa.flash_bwd_dkv_plain(q, k, v, do, lse, drow,
                                             q_offset, ln)
        torch.cuda.synchronize()
        assert (tfa.flash_ragged_lse.launches, tfa.flash_bwd_dq.launches,
                tfa.flash_bwd_dkv.launches) == tuple(n + 1 for n in n0)
        for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            _held(got, want)
            assert torch.count_nonzero(got[1]) == 0
