"""The port's ``SpeculativeEngine`` (the dense side-car) against the JAX
package's, on the cases of ``tests/test_speculative.py``.

The same parameters (the reference's ``init_params`` trees carried over)
go to both. Greedy tokens equal the reference's ``SpeculativeEngine`` and
vanilla greedy (the port's ``Engine``) for a self-draft, a random draft
and k in {1, 2, 4}; EOS, ``max_new=1``; sampled streams equal the
reference's for the same seed (both draw every emitted token from the
target under the same threefry keys), which also pins the sampling law
the reference's distribution tests measure; the incremental group path
equals the bulk path bitwise.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import ModelConfig as JMC
from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference.speculative import SpeculativeEngine as JS
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.config import ModelConfig as TMC
from kubeinfer_tpu_torch.inference.engine import Engine as TE
from kubeinfer_tpu_torch.inference.speculative import SpeculativeEngine as TS

JT, TT = JP["tiny"], TP["tiny"]
DRAFT = dict(vocab_size=JT.vocab_size, hidden_size=32, intermediate_size=64,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=2,
             max_position_embeddings=JT.max_position_embeddings)
JD, TD = JMC(**DRAFT), TMC(**DRAFT)


def conv(p):
    return tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


@pytest.fixture(scope="module")
def models():
    p = j_init(JT, jax.random.PRNGKey(0))
    d = j_init(JD, jax.random.PRNGKey(9))
    return p, d, conv(p), conv(d)


def engines(models, draft, k, **kw):
    """(reference, port) SpeculativeEngines; ``draft`` "self" or
    "random"."""
    p, d, tp, td = models
    if draft == "self":
        return (JS(p, JT, p, JT, k=k, **kw),
                TS(tp, TT, tp, TT, k=k, device="cpu", **kw))
    return (JS(p, JT, d, JD, k=k, **kw),
            TS(tp, TT, td, TD, k=k, device="cpu", **kw))


def vanilla(models, prompts, max_new, eos_id=-1):
    return TE(models[2], TT, device="cpu").generate(
        prompts, max_new_tokens=max_new, eos_id=eos_id)


def equal(a, b):
    np.testing.assert_array_equal(a.tokens, b.tokens)
    np.testing.assert_array_equal(a.lengths, b.lengths)


@pytest.mark.parametrize("draft,k,prompts,new", [
    ("self", 4, [[3, 1, 4, 1, 5], [9, 2, 6]], 12),
    ("random", 3, [[7, 7, 7], [1, 2, 3, 4, 5, 6, 7, 8]], 10),
], ids=["self_draft", "random_draft"])
def test_greedy_equals_reference_and_vanilla(models, draft, k, prompts, new):
    jeng, teng = engines(models, draft, k)
    got = teng.generate(prompts, max_new_tokens=new)
    equal(got, jeng.generate(prompts, max_new_tokens=new))
    equal(got, vanilla(models, prompts, new))
    assert got.tokens.dtype == np.int32 and got.lengths.dtype == np.int32


@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculation_depth_invariance(models, k):
    prompts = [[5, 4, 3, 2]]
    jeng, teng = engines(models, "random", k)
    got = teng.generate(prompts, max_new_tokens=8)
    equal(got, jeng.generate(prompts, max_new_tokens=8))
    equal(got, vanilla(models, prompts, 8))


def test_eos(models):
    """EOS as the first token stops at length 1, EOS-padded; EOS mid-stream
    matches vanilla and the reference."""
    jeng, teng = engines(models, "self", 4)
    prompts = [[2, 3, 4]]
    eos = int(vanilla(models, prompts, 6).tokens[0, 0])
    out = teng.generate(prompts, max_new_tokens=6, eos_id=eos)
    assert out.lengths[0] == 1 and (out.tokens[0] == eos).all()
    prompts = [[11, 12, 13, 14]]
    eos = int(vanilla(models, prompts, 10).tokens[0, 2])
    got = teng.generate(prompts, max_new_tokens=10, eos_id=eos)
    equal(got, vanilla(models, prompts, 10, eos_id=eos))
    equal(got, jeng.generate(prompts, max_new_tokens=10, eos_id=eos))


def test_max_new_one(models):
    _, teng = engines(models, "random", 2)
    equal(teng.generate([[1, 2]], max_new_tokens=1),
          vanilla(models, [[1, 2]], 1))


def test_refusals_and_fits(models):
    _, _, tp, td = models
    bad = TMC(**{**DRAFT, "vocab_size": JT.vocab_size * 2})
    with pytest.raises(ValueError, match="vocabulary"):
        TS(tp, TT, td, bad, device="cpu")
    with pytest.raises(ValueError, match="k must be >= 1"):
        TS(tp, TT, tp, TT, k=0, device="cpu")
    eng = TS(tp, TT, tp, TT, k=4, max_cache_len=64, device="cpu")
    assert eng.fits(32, 27)  # 32 + 27 + 5 = 64
    assert not eng.fits(32, 28)


def test_self_draft_sustained_acceptance(models):
    """Draft == target: 20 post-first tokens in ceil(20 / 5) = 4 rounds
    (the repair window keeps the draft cache whole)."""
    _, teng = engines(models, "self", 4)
    out = teng.generate([[3, 1, 4, 1, 5]], max_new_tokens=21)
    assert out.lengths[0] == 21
    rounds = teng.last_stats["rounds"]
    assert rounds <= 5
    assert teng.last_stats["accepted_drafts"][0] >= 21 - 1 - rounds


@pytest.mark.parametrize("draft", ["self", "random"])
def test_sampled_equals_reference(models, draft):
    """Sampled streams equal the reference's for the same seed (so they
    follow the target's sampling law exactly, as the reference's own
    distribution tests show for it); another seed gives another stream."""
    jeng, teng = engines(models, draft, 3)
    prompts = [[5, 6, 7], [2, 3, 4, 9]]
    kw = dict(temperature=0.7, top_p=0.9, top_k=40)
    got = teng.generate(prompts, max_new_tokens=8, seed=11, **kw)
    equal(got, jeng.generate(prompts, max_new_tokens=8, seed=11, **kw))
    other = teng.generate(prompts, max_new_tokens=8, seed=12, **kw)
    assert not np.array_equal(got.tokens, other.tokens)
    if draft == "self":
        assert teng.last_stats["accepted_drafts"].sum() >= 6


def _incremental(eng, prompts, max_new, **kw):
    g = eng.start_group(prompts, max_new_tokens=max_new, **kw)
    rounds = 0
    while not eng.step_group(g):
        rounds += 1
        assert rounds <= max_new + 2, "group never converged"
    return eng.finish_group(g)


@pytest.mark.parametrize("case", ["greedy", "sampled", "eos"])
def test_group_path_equals_bulk(models, case):
    _, teng = engines(models, "self" if case == "eos" else "random", 3)
    prompts = [[5, 6, 7], [2, 3], [9, 1, 4, 8]]
    if case == "greedy":
        bulk = teng.generate(prompts, max_new_tokens=6)
        inc = _incremental(teng, prompts, 6)
    elif case == "sampled":
        bulk = teng.generate(prompts[:2], max_new_tokens=5, temperature=0.8,
                             top_p=0.9, seed=13)
        inc = _incremental(teng, prompts[:2], 5, temperatures=[0.8, 0.8],
                           top_ps=[0.9, 0.9], seed=13)
    else:
        eos = int(teng.generate([[5, 17, 42]], max_new_tokens=8).tokens[0, 1])
        bulk = teng.generate([[5, 17, 42]], max_new_tokens=8, eos_id=eos)
        inc = _incremental(teng, [[5, 17, 42]], 8, eos_id=eos)
    equal(inc, bulk)


def test_needs_cuda_by_default(models, monkeypatch):
    _, _, tp, _ = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS(tp, TT, tp, TT)
