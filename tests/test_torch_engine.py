"""The port's per-request ``Engine`` against the JAX package's on the
same parameters: token streams EQUAL, greedy and sampled (temperature
0.8 with top-k, top-p and a repetition penalty, seed stated), ragged
prompts, EOS; ``chunked_prefill`` logits within 1e-5 (f32). The port
runs the plain versions of kernels #9 (prefill) and #10 (decode) on the
CPU; the reference runs its dense path there."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import config as jc
from kubeinfer_tpu.inference import engine as je
from kubeinfer_tpu.inference import model as jm
from kubeinfer_tpu_torch.inference import config as tc
from kubeinfer_tpu_torch.inference import engine as te
from kubeinfer_tpu_torch.inference import weights as tw

# a D = 64 model: head width of the serving presets, cache widths are
# buckets (multiples of 16)
D64 = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
           num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
           max_position_embeddings=512)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, repetition_penalty=1.3,
               seed=11)


def make(name):
    if name == "tiny":
        jcfg, tcfg = jc.PRESETS["tiny"], tc.PRESETS["tiny"]
    else:
        jcfg, tcfg = jc.ModelConfig(**D64), tc.ModelConfig(**D64)
    p = jm.init_params(jcfg, jax.random.PRNGKey(6))
    tp = tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")
    return (jcfg, tcfg, p, tp, je.Engine(p, jcfg, max_cache_len=128),
            te.Engine(tp, tcfg, max_cache_len=128, device="cpu"))


@pytest.fixture(scope="module", params=["tiny", "d64"])
def engines(request):
    return make(request.param)


PROMPTS = [[3, 14, 15, 9, 2], list(range(1, 30)), [200] * 17]


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_generate_equal_tokens(engines, kw):
    *_, jeng, teng = engines
    want = jeng.generate(PROMPTS, 12, **kw)
    got = teng.generate(PROMPTS, 12, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert got.tokens.dtype == np.int32 and got.lengths.dtype == np.int32


def test_generate_eos_lengths(engines):
    *_, jeng, teng = engines
    eos = int(jeng.generate(PROMPTS[:1], 6).tokens[0, 3])
    want = jeng.generate(PROMPTS, 8, eos_id=eos)
    got = teng.generate(PROMPTS, 8, eos_id=eos)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)
    assert 1 <= got.lengths[0] <= 4  # the first EOS ends the row


def test_chunked_prefill_logits(engines):
    """Two chunks of 16 over a 32-wide bucket, ragged rows."""
    jcfg, tcfg, p, tp, *_ = engines
    prompt = np.zeros((2, 32), np.int32)
    prompt[0, :29] = np.arange(1, 30)
    prompt[1, :7] = [5, 6, 7, 8, 9, 10, 11]
    lens = np.array([29, 7], np.int32)
    caches = je.make_caches(jcfg, 2, 64, jnp.float32)
    _, want = je.chunked_prefill(p, jnp.asarray(prompt), jnp.asarray(lens),
                                 jcfg, caches, 16)
    tcaches = te.make_caches(tcfg, 2, 64, torch.float32, "cpu")
    _, got = te.chunked_prefill(tp, torch.from_numpy(prompt),
                                torch.from_numpy(lens), tcfg, tcaches, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_prompt_prep_and_buckets():
    for n in (1, 16, 17, 600):
        assert te._bucket(n) == je._bucket(n)
    for b, t in ((1, 4096), (3, 2048), (8, 512), (1, 16)):
        assert te.prefill_chunk_for(b, t) == je.prefill_chunk_for(b, t)
    a = te.prepare_prompts([[1, 2], [3] * 20], 8, 128)
    b = je.prepare_prompts([[1, 2], [3] * 20], 8, 128)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="context"):
        te.prepare_prompts([[1] * 100], 40, 128)


def test_filter_logits_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 300)).astype(np.float32)
    k = np.array([0, 5, 64, 100], np.int32)
    p = np.array([1.0, 0.5, 0.9, 0.0], np.float32)
    want = np.asarray(je.filter_logits(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(p)))
    got = te.filter_logits(torch.from_numpy(x), torch.from_numpy(k),
                           torch.from_numpy(p), topk_on=True, topp_on=True)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(want))
    with pytest.raises(TypeError, match="host"):
        te.filter_logits(torch.from_numpy(x), torch.from_numpy(k), 1.0)


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_generate_int8_weights(kw):
    """The reference's ``init_params(weight_dtype="int8")`` tree on both
    engines (every projection through #15's plain version on the CPU):
    token streams equal."""
    jcfg, tcfg = jc.ModelConfig(**D64), tc.ModelConfig(**D64)
    p = jm.init_params(jcfg, jax.random.PRNGKey(4), weight_dtype="int8")
    tp = tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")
    want = je.Engine(p, jcfg, max_cache_len=128).generate(PROMPTS, 10, **kw)
    got = te.Engine(tp, tcfg, max_cache_len=128, device="cpu").generate(
        PROMPTS, 10, **kw)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.lengths, want.lengths)


def test_engine_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.Engine({}, tc.PRESETS["tiny"])
