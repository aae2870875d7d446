"""Tensor parallelism on the card (``cuda``-marked; skips without one). No
JAX here: a tp=2 ``ContinuousEngine`` over ``["cuda:0", "cuda:0"]`` (two
ranks on one H100) and, where two cards are visible, over the first two
(the default mesh, every kernel launched under its rank's card) against
the tp=1 engine on the same f32 parameters,
block size 128 and head width 64, so the paged decode kernel (#11, or #12
on the int8 pool) and, with int8 weights, #15 launch on every shard:
greedy and sampled streams equal, every paged decode call on a rank's
one KV head and held to its plain version (f32 within 1e-5), every #15
call on a rank's slice of a projection. With two cards, the server's
``--tensor-parallel-size 2`` and no mesh answers the tp=1 streams over
HTTP."""

from __future__ import annotations

import dataclasses
import json
import urllib.request

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import flash_attention as fa
from kubeinfer_tpu_torch.inference import server
from kubeinfer_tpu_torch.inference import weight_quant as wq
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.model import init_params
from kubeinfer_tpu_torch.inference.sharding import EngineLayout

CFG = dataclasses.replace(PRESETS["tiny"], hidden_size=256,
                          intermediate_size=512, num_attention_heads=4,
                          num_key_value_heads=2,
                          max_position_embeddings=1024)


def serve(params, kv, tp, cards=1):
    devices = ["cuda:0"] * tp if cards == 1 else None
    eng = ContinuousEngine(
        params, CFG, n_slots=2, cache_len=256, block_size=128,
        kv_dtype=kv, weight_dtype=kv, device="cuda",
        layout=EngineLayout.build(tp, devices) if tp > 1 else None,
    ).start()
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 256, n).tolist() for n in (140, 9)]
    try:
        return [eng.generate(p, 12) for p in prompts] + [
            eng.generate(prompts[0], 12, temperature=0.8, top_k=20, seed=4)]
    finally:
        eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [1, 2])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tp2_equals_tp1(monkeypatch, kv, cards):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    if torch.cuda.device_count() < cards:
        pytest.skip(f"needs {cards} NVIDIA cards")
    params = init_params(CFG, seed=0, dtype=torch.float32, device="cuda")
    want = serve(params, kv, 1)
    name = "decode_attention_blocks" + ("_q8" if kv == "int8" else "")
    kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
    calls, mms = [], []

    def checked(q, k_pool, *rest):
        out = kernel(q, k_pool, *rest)
        err = float((out - plain(q, k_pool, *rest)).abs().max())
        calls.append((q.shape[2], k_pool.shape[2], err, str(q.device)))
        return out

    checked.launches = 0
    checked.walk_counter = None
    real_qmm = wq.quant_matmul

    def qmm(x, qw, scale):
        mms.append((tuple(qw.shape), str(qw.device)))
        return real_qmm(x, qw, scale)

    # the wrapper counts its launches on the name the module holds
    qmm.launches = qmm.tc_launches = 0

    monkeypatch.setattr(fa, name, checked)
    monkeypatch.setattr(wq, "quant_matmul", qmm)
    got = serve(params, kv, 2, cards)
    torch.cuda.synchronize()
    assert got == want
    # one KV head (two query heads) a rank, on every paged decode call,
    # each rank on its own card when there are two
    ranks = {f"cuda:{r if cards == 2 else 0}" for r in range(2)}
    assert calls and {c[:2] for c in calls} == {(2, 1)}
    assert max(c[2] for c in calls) <= 1e-5
    assert {c[3] for c in calls} == ranks
    if kv == "int8":
        assert qmm.launches == len(mms) > 0
        H, F = CFG.hidden_size, CFG.intermediate_size
        assert {m[0] for m in mms} == {(H, H // 2), (H, H // 4), (H // 2, H),
                                       (H, F // 2), (F // 2, H)}
        assert {m[1] for m in mms} == ranks


@pytest.mark.cuda
def test_tp2_server_on_two_cards_equals_tp1():
    """``--tensor-parallel-size 2`` without a mesh: the first two visible
    cards, one rank each, for the batcher, the per-request engine and the
    draft; a batcher request and a speculative one answer tp=1's (f32:
    the bf16 partial sums round in another order than tp=1's)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA cards")
    flags = ["--model", "tiny", "--random-init", "--port", "0", "--host",
             "127.0.0.1", "--max-model-len", "256", "--draft-model", "tiny",
             "--dtype", "float32"]
    body = json.dumps(dict(prompt=[3, 1, 4, 1, 5, 9, 2, 6],
                           max_tokens=6)).encode()
    answers = []
    for tp in ("1", "2"):
        for slots in ("2", "0"):
            srv, cont = server.build_server(
                flags + ["--batch-slots", slots, "--tensor-parallel-size",
                         tp])
            if cont is not None:
                cont.start()
            srv.start()
            try:
                req = urllib.request.Request(
                    f"http://127.0.0.1:{srv.port}/v1/completions", data=body,
                    headers={"Content-Type": "application/json"})
                out = json.loads(urllib.request.urlopen(req, timeout=300)
                                 .read())
                answers.append((out["kubeinfer"]["route"],
                                out["choices"][0]["tokens"]))
            finally:
                srv.stop()
                if cont is not None:
                    cont.stop()
            if tp == "2":
                assert srv.engine.params.devices == [
                    torch.device("cuda", 0), torch.device("cuda", 1)]
    assert [a[0] for a in answers] == ["continuous", "speculative"] * 2
    assert answers[2:] == answers[:2]
