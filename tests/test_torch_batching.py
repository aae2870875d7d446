"""The port's ``ContinuousEngine(device="cpu")`` against the JAX
package's on the same parameters, 4 slots, ``block_size=16`` (the plain
version of kernel #11 reads the pool): four concurrent requests, two of
which share a prefix longer than a block (a radix hit when the first
prefills whole), submitted before the scheduler starts so that both
engines admit them in the same order. Token streams EQUAL, greedy and
sampled, with whole-suffix and chunked (``prefill_chunk_blocks=1``)
prefill; after retirement the free-block, trie-node and hit/miss counts
are equal. The int8 axes (``kv_dtype``, ``weight_dtype``; the plain
versions of kernels #12 and #15) run the same way with the same flags on
both engines, 40 new tokens crossing two 16-wide blocks: streams equal,
and ``quant_blocks_total``, ``kv_pool_bytes`` and ``model_param_bytes``
equal to the reference's."""

from __future__ import annotations

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.batching import PreemptionPolicy
from kubeinfer_tpu_torch.inference.config import PRESETS as TP

SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9, repetition_penalty=1.3)
STATS = ("hits", "misses", "nodes", "leaves", "blocks_free",
         "blocks_in_use")

rng = np.random.default_rng(1)
SHARED = rng.integers(1, 256, 40).tolist()  # 2.5 blocks of 16
PROMPTS = [SHARED + [5, 6, 7], SHARED + [9, 10, 11, 12],
           rng.integers(1, 256, 20).tolist(), rng.integers(1, 256, 7).tolist()]


@pytest.fixture(scope="module")
def params():
    p = j_init(JP["tiny"], jax.random.PRNGKey(6))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def serve(eng, kw, new=10):
    """The four requests in flight together; returns their streams."""
    reqs = [eng.submit(p, new + i, seed=i, **kw)
            for i, p in enumerate(PROMPTS)]
    eng.start()
    for r in reqs:
        assert r.done.wait(120) and not r.failed
    return [r.out_tokens for r in reqs]


@pytest.mark.parametrize("chunk", [0, 1])
@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_streams_and_pool_match_reference(params, chunk, kw):
    jp, tp = params
    cfg = dict(n_slots=4, cache_len=128, block_size=16,
               prefill_chunk_blocks=chunk)
    je = JC(jp, JP["tiny"], **cfg)
    te = TC(tp, TP["tiny"], device="cpu", **cfg)
    try:
        want, got = serve(je, kw), serve(te, kw)
        assert got == want
        js, ts = je.kv_cache_stats(), te.kv_cache_stats()
        assert {k: ts[k] for k in STATS} == {k: js[k] for k in STATS}
        if not chunk:
            assert ts["hits"] >= 1  # the shared prefix was reused
        assert ts["blocks_in_use"] == ts["nodes"]  # only the trie holds
        assert te.cache_summary()["fingerprints"] == \
            je.cache_summary()["fingerprints"]
        if chunk:
            assert te.chunks_total > 0
    finally:
        je.stop()
        te.stop()


INT8 = [("int8", "bf16", 0, {}), ("bf16", "int8", 0, {}),
        ("int8", "int8", 0, {}), ("int8", "int8", 0, SAMPLED),
        ("int8", "int8", 1, {})]


@pytest.mark.parametrize("kv,w,chunk,kw", INT8,
                         ids=["kv8", "w8", "both", "both-sampled",
                              "both-chunked"])
def test_int8_axes_match_reference(params, kv, w, chunk, kw):
    jp, tp = params
    cfg = dict(n_slots=4, cache_len=128, block_size=16,
               prefill_chunk_blocks=chunk, kv_dtype=kv, weight_dtype=w)
    je = JC(jp, JP["tiny"], **cfg)
    te = TC(tp, TP["tiny"], device="cpu", **cfg)
    try:
        want, got = serve(je, kw, 40), serve(te, kw, 40)
        assert got == want
        assert te.quant_blocks_total == je.quant_blocks_total
        if kv == "int8":
            assert te.quant_blocks_total > 0
        assert te.kv_pool_bytes == je.kv_pool_bytes
        assert te.model_param_bytes == je.model_param_bytes
        assert te.kv_cache_stats()["quant_blocks"] == te.quant_blocks_total
        if chunk:
            assert te.chunks_total > 0
    finally:
        je.stop()
        te.stop()


def test_int8_warm_radix_admit(params):
    """A prompt admitted twice on the int8 pool: the second admit reuses
    the first one's quantized blocks (dequantized into its view), and
    both engines give the same two streams."""
    jp, tp = params
    cfg = dict(n_slots=2, cache_len=128, block_size=16, kv_dtype="int8",
               weight_dtype="int8")
    prompt = PROMPTS[0] + PROMPTS[2]  # 63 tokens, 3 full blocks
    out = []
    for eng in (JC(jp, JP["tiny"], **cfg),
                TC(tp, TP["tiny"], device="cpu", **cfg)):
        eng.start()
        try:
            first = eng.generate(prompt, 24, timeout=120)
            again = eng.generate(prompt, 24, timeout=120)
            assert eng.kv_cache_stats()["hits"] == 1
            out.append((first, again, eng.quant_blocks_total))
        finally:
            eng.stop()
    assert out[1] == out[0]


def test_weight_dtype_guard(params):
    _, tp = params
    from kubeinfer_tpu_torch.inference.weight_quant import quantize_params
    with pytest.raises(ValueError, match="weight-quantized"):
        TC(quantize_params(tp), TP["tiny"], cache_len=64, device="cpu")
    eng = TC(quantize_params(tp), TP["tiny"], cache_len=64, device="cpu",
             weight_dtype="int8")
    assert eng.weight_dtype == "int8"
    for kw in (dict(kv_dtype="fp8"), dict(weight_dtype="fp8")):
        with pytest.raises(ValueError, match="'bf16' or 'int8'"):
            TC(tp, TP["tiny"], cache_len=64, device="cpu", **kw)


def test_waiting_features_raise(params):
    """A sharded layout still waits; preemption and drain() are accepted
    (the drain of an idle engine completes, and undrain() reopens it)."""
    _, tp = params
    with pytest.raises(ValueError, match="layout"):
        TC(tp, TP["tiny"], cache_len=64, device="cpu", layout=object())
    pol = PreemptionPolicy(threshold_s=0.25)
    eng = TC(tp, TP["tiny"], cache_len=64, device="cpu", preemption=pol)
    assert eng.preemption is pol and eng.scheduler_stats()["preempted"] == 0
    eng = TC(tp, TP["tiny"], n_slots=2, cache_len=64, device="cpu").start()
    try:
        eng.drain()
        assert eng.draining and eng.wait_drained(10.0)
        eng.undrain()
        assert not eng.draining and len(eng.generate([1, 2, 3], 2)) == 2
    finally:
        eng.stop()
    assert not eng.fits(60, 10) and eng.fits(10, 10)


def test_stop_fails_queued_requests(params):
    _, tp = params
    eng = TC(tp, TP["tiny"], n_slots=2, cache_len=64, device="cpu")
    req = eng.submit([1, 2, 3], 4)  # never started
    eng.stop()
    assert req.done.is_set() and "stopped" in req.failed


def test_continuous_needs_cuda_by_default(params, monkeypatch):
    _, tp = params
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC(tp, TP["tiny"], cache_len=64)


def test_threads_submitting_together(params):
    """Eight threads against two slots with a short switch interval: every
    request completes with its full budget, every admit is counted once,
    and every block goes back to the pool or the trie."""
    _, tp = params
    eng = TC(tp, TP["tiny"], n_slots=2, cache_len=64, block_size=16,
             device="cpu").start()
    prompts = [np.random.default_rng(i).integers(1, 256, 5 + 3 * i).tolist()
               for i in range(8)]
    out = [None] * 8
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, eng.generate(prompts[i], 6, seed=i, timeout=120)))
            for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert all(len(o) == 6 and all(0 <= t < 256 for t in o) for o in out)
    st = eng.kv_cache_stats()
    assert st["hits"] + st["misses"] == 8
    assert st["blocks_in_use"] == st["nodes"]
