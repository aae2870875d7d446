"""Speculative verify windows on the port's paged continuous batch
(``ContinuousEngine(spec_draft=...)``, ``stepper.verify_window``) against
the JAX package, on the cases of ``tests/test_inference_spec_verify.py``
without its two slow ones (preemption cycles and tp=2, which wait for
ROADMAP Queue 1 entries 4 and 10).

- Token identity for any draft: the port's speculative streams, greedy
  and sampled, equal the reference's PLAIN engine's (``max_window=1``)
  on the same parameters, for a random 1-layer draft (every window rolls
  back), a self-draft (every draft accepted) and a 0-layer bigram draft,
  on the bf16 and the int8 pool, cold and warm (radix) admits.
- ``verify_window`` itself: three windows on engine states admitted the
  same way in both packages (one greedy slot, one sampled slot with a
  repetition penalty), tokens equal window by window; ``spec_accept``
  equal on random proposals.
- On a card: #11 and #12 at T = 5 (a verify window of k = 4) against
  their plain versions, with windows that start a few slots before a
  128-block edge (#12's tail slot 1).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import stepper as jst
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import stepper as tst
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.config import PRESETS as TP

JT, TT = JP["tiny"], TP["tiny"]
JD, TD = (dataclasses.replace(c, num_hidden_layers=1) for c in (JT, TT))
SAMPLED = dict(temperature=0.8, seed=5, top_k=13)
BF16_REL = 2.0 ** -6


def conv(p):
    return tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def models():
    p = j_init(JT, jax.random.PRNGKey(6))
    d = j_init(JD, jax.random.PRNGKey(7))  # an unrelated 1-layer draft
    return p, d, conv(p), conv(d)


def prompt_of(seed, n):
    return np.random.default_rng(seed).integers(0, JT.vocab_size,
                                                n).tolist()


# (seed, prompt length, new tokens): the reference file's prompts
PROMPTS = {"cold": (41, 9, 9), "self": (42, 7, 8), "bigram": (47, 8, 8),
           "warm": (43, 9, 8)}


@pytest.fixture(scope="module")
def want(models):
    """The reference's plain engine (one token a window), greedy and
    sampled, on every prompt of this file."""
    p, *_ = models
    eng = JC(p, JT, n_slots=2, cache_len=64, block_size=8,
             max_window=1).start()
    try:
        return {name: (eng.generate(prompt_of(s, n), max_new_tokens=m),
                       eng.generate(prompt_of(s, n), max_new_tokens=m,
                                    **SAMPLED))
                for name, (s, n, m) in PROMPTS.items()}
    finally:
        eng.stop()


def port_engine(tp, draft, kv, **kw):
    return TC(tp, TT, n_slots=2, cache_len=64, block_size=8, spec_draft=draft,
              spec_k=4, kv_dtype=kv, device="cpu", **kw).start()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_cold_identity_random_draft(models, want, kv):
    """A draft that almost never agrees: every window rolls back, and the
    streams are still the plain engine's."""
    _, _, tp, td = models
    s, n, m = PROMPTS["cold"]
    eng = port_engine(tp, (td, TD), kv)
    try:
        got_g = eng.generate(prompt_of(s, n), max_new_tokens=m)
        got_s = eng.generate(prompt_of(s, n), max_new_tokens=m, **SAMPLED)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert (got_g, got_s) == want["cold"]
    assert stats["spec_draft_tokens"] > 0 and stats["spec_rollbacks"] > 0
    assert stats["spec_accepted_tokens"] <= stats["spec_draft_tokens"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_self_draft_full_acceptance(models, want, kv):
    _, _, tp, _ = models
    s, n, m = PROMPTS["self"]
    eng = port_engine(tp, (tp, TT), kv)
    try:
        got = eng.generate(prompt_of(s, n), max_new_tokens=m)
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert got == want["self"][0]
    assert stats["spec_draft_tokens"] > 0
    assert stats["spec_accepted_tokens"] == stats["spec_draft_tokens"]
    assert stats["spec_rollbacks"] == 0


def test_bigram_draft_identity(models, want):
    """A 0-layer draft (embed, norm, head): no draft KV, the admit sets
    only ``prev``."""
    _, _, tp, _ = models
    dcfg = dataclasses.replace(TT, num_hidden_layers=0)
    dparams = {k: tp[k] for k in ("embed_tokens", "norm", "lm_head")}
    dparams["layers"] = []
    s, n, m = PROMPTS["bigram"]
    eng = port_engine(tp, (dparams, dcfg), "bf16")
    try:
        got = (eng.generate(prompt_of(s, n), max_new_tokens=m),
               eng.generate(prompt_of(s, n), max_new_tokens=m, **SAMPLED))
        stats = eng.scheduler_stats()
    finally:
        eng.stop()
    assert got == want["bigram"]
    assert stats["spec_draft_tokens"] > 0


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_warm_admit_identity(models, want, kv):
    """The second admit of a prompt reuses its cached blocks; the draft
    re-prefills the full prompt; streams stay equal."""
    _, _, tp, td = models
    s, n, m = PROMPTS["warm"]
    eng = port_engine(tp, (td, TD), kv)
    try:
        assert eng.generate(prompt_of(s, n), max_new_tokens=m) == \
            want["warm"][0]
        hits0 = eng.kv_cache_stats()["hits"]
        got = (eng.generate(prompt_of(s, n), max_new_tokens=m),
               eng.generate(prompt_of(s, n), max_new_tokens=m, **SAMPLED))
        warm_hits = eng.kv_cache_stats()["hits"] - hits0
    finally:
        eng.stop()
    assert got == want["warm"]
    assert warm_hits >= 1


def test_constructor_validation(models):
    _, _, tp, td = models
    with pytest.raises(ValueError, match="spec_k must be >= 1"):
        TC(tp, TT, n_slots=2, cache_len=64, block_size=8,
           spec_draft=(td, TD), spec_k=0, device="cpu")
    bad = dataclasses.replace(TD, vocab_size=128)
    with pytest.raises(ValueError, match="vocabulary"):
        TC(tp, TT, n_slots=2, cache_len=64, block_size=8,
           spec_draft=(td, bad), device="cpu")
    with pytest.raises(ValueError, match="leaves no room"):
        TC(tp, TT, n_slots=2, cache_len=8, block_size=8,
           spec_draft=(td, TD), spec_k=8, device="cpu")


def test_spec_accept_matches_reference():
    rng = np.random.default_rng(3)
    for k in (1, 2, 4):
        drafts = rng.integers(0, 3, (64, k))
        target = rng.integers(0, 3, (64, k + 1))
        want = np.asarray(jst.spec_accept(jnp.asarray(drafts, jnp.int32),
                                          jnp.asarray(target, jnp.int32)))
        got = tst.spec_accept(torch.from_numpy(drafts),
                              torch.from_numpy(target))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_verify_window_matches_reference(models, kv):
    """Three verify windows on the same admitted slots (one greedy, one
    sampled with a repetition penalty, so ``seen`` threads the accepted
    prefix), tokens equal window by window; block 8, so the windows cross
    block edges (the int8 tail commit)."""
    p, d, tp, td = models
    reqs = [(prompt_of(50, 6), {}),
            (prompt_of(51, 11), dict(temperature=0.9, top_k=20, top_p=0.9,
                                     repetition_penalty=1.3, seed=8))]
    jeng = JC(p, JT, n_slots=2, cache_len=64, block_size=8,
              spec_draft=(d, JD), spec_k=4, kv_dtype=kv)
    teng = TC(tp, TT, n_slots=2, cache_len=64, block_size=8,
              spec_draft=(td, TD), spec_k=4, kv_dtype=kv, device="cpu")
    for eng in (jeng, teng):
        for prompt, kw in reqs:
            eng.submit(prompt, 30, **kw)
        eng._admit_pending()  # both rows installed; the loop never runs
    for _ in range(3):
        jeng._state, jeng._dstate, jt = jst.verify_window(
            jeng.params, jeng._state, jeng._dparams, jeng._dstate, JT, JD, 4)
        teng._state, teng._dstate, tt = tst.verify_window(
            teng.params, teng._state, teng._dparams, teng._dstate, TT, TD, 4,
            teng._flags())
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(teng._state.offset.numpy(),
                                  np.asarray(jeng._state.offset))
    np.testing.assert_array_equal(teng._state.seen.numpy(),
                                  np.asarray(jeng._state.seen))
    jeng.stop()
    teng.stop()


# --- on the card -------------------------------------------------------------


def q8_inputs(B, T, n_kv, G, D, bs, M, lens, seed):
    """Random int8 pages and scales, permuted null-padded tables, tails
    independent of the pool, and the bf16-pool twin of the same shapes."""
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


def _held_rows(got, want, live):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    B = g.shape[0]
    err = (g - w).abs().reshape(B, -1).amax(dim=1)[live]
    mag = w.abs().reshape(B, -1).amax(dim=1)[live]
    if got.dtype == torch.float32:
        assert (err <= 1e-5).all(), err
    else:
        assert (err <= BF16_REL * mag).all(), (err, mag)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_verify_width_kernels_on_card(dtype):
    """#12 and #11 at T = 5, block 128: windows that start 1-4 slots before
    a block edge (#12 reads tail slot min(j - tb, 1) = 1 past it), one
    that starts on an edge, and one inside a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    dev = torch.device("cuda")
    T, bs, D = 5, 128, 128
    # lengths o + T: starts at 127, 124, 255, 256, 300 and 385
    lens = [132, 129, 260, 261, 305, 390]
    B = len(lens)
    ins = q8_inputs(B, T, 2, 4, D, bs, 4, lens, 7)
    args = [torch.from_numpy(np.array(a)).to(dev) for a in ins]
    for i in (0, 5, 6):
        args[i] = args[i].to(dtype)
    n12 = tfa.decode_attention_blocks_q8.launches
    got = tfa.decode_attention_blocks_q8(*args)
    want = tfa.decode_attention_blocks_q8_plain(*args)
    torch.cuda.synchronize()
    assert tfa.decode_attention_blocks_q8.launches == n12 + 1
    live = torch.ones(B, dtype=torch.bool)
    _held_rows(got, want, live)
    # the same walk over a bf16 pool (the dequantized pages): #11
    kp = (args[1].float() * args[3][:, None, :, None]).to(dtype)
    vp = (args[2].float() * args[4][:, None, :, None]).to(dtype)
    n11 = tfa.decode_attention_blocks.launches
    got = tfa.decode_attention_blocks(args[0], kp, vp, args[7], args[8])
    want = tfa.decode_attention_blocks_plain(args[0], kp, vp, args[7],
                                             args[8])
    torch.cuda.synchronize()
    assert tfa.decode_attention_blocks.launches == n11 + 1
    _held_rows(got, want, live)
