"""The port's ``InferenceServer`` on an ephemeral port with
``device="cpu"``, serving ``tiny``: the read endpoints answer, a fitting
request rides the continuous batcher and an over-slot-width one the
per-request engine, each returning its engine's own tokens; routes and
flags that wait answer 400 or exit with the ROADMAP entry. The load
path (``--model <checkpoint dir>``) is ``tests/test_torch_load.py``'s."""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest
import torch

from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.model import init_params

CFG = PRESETS["tiny"]


@pytest.fixture(scope="module")
def served():
    params = init_params(CFG, seed=3, device="cpu")
    engine = Engine(params, CFG, max_cache_len=256, device="cpu")
    cont = ContinuousEngine(params, CFG, n_slots=2, cache_len=64,
                            device="cpu").start()
    srv = ts.InferenceServer(engine, "tiny", port=0, continuous=cont,
                             device="cpu").start()
    yield srv, engine, cont
    srv.stop()
    cont.stop()


def call(srv, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = None if body is None else json.dumps(body).encode()
    try:
        with urllib.request.urlopen(url, data=data, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_read_endpoints(served):
    srv, *_ = served
    assert call(srv, "/health") == (200, "OK")
    code, body = call(srv, "/v1/models")
    assert code == 200 and json.loads(body)["data"][0]["id"] == "tiny"
    code, text = call(srv, "/metrics")
    assert code == 200 and "kubeinfer_inference_requests_total" in text


@pytest.mark.parametrize("kw", [{}, dict(temperature=0.7, top_k=5, seed=4)])
def test_routes_return_their_engines_tokens(served, kw):
    srv, engine, cont = served
    short = [3, 1, 4, 1, 5, 9, 2, 6]
    code, body = call(srv, "/v1/completions",
                      dict(prompt=short, max_tokens=6, **kw))
    resp = json.loads(body)
    assert code == 200 and resp["kubeinfer"]["route"] == "continuous"
    toks = resp["choices"][0]["tokens"]
    assert toks == cont.generate(short, 6, **kw)
    assert resp["usage"] == {"prompt_tokens": 8, "completion_tokens": 6,
                             "total_tokens": 14}
    long = list(range(1, 61))  # 60 + 8 > the 64-wide slots
    code, body = call(srv, "/v1/completions",
                      dict(prompt=long, max_tokens=8, **kw))
    resp = json.loads(body)
    assert code == 200 and resp["kubeinfer"]["route"] == "engine"
    out = engine.generate([long], 8, **kw)
    assert resp["choices"][0]["tokens"] == out.tokens[0].tolist()


@pytest.mark.parametrize("body,msg", [
    # prefill-only needs a prompt the 64-wide slots can take
    (dict(prompt=list(range(1, 71)), max_tokens=0), "prefill-only"),
    # a resume rides the continuous batcher only: 70 + 4 > its 64 slots
    (dict(prompt=list(range(1, 71)), max_tokens=4,
          kubeinfer_resume={"tokens": [3]}), "resume"),
    (dict(prompt="hello"), "tokenizer"),
    (dict(prompt=[1, 2], top_p=0.0), "top_p"),
    (dict(max_tokens=3), "prompt"),
])
def test_waiting_and_invalid_bodies_answer_400(served, body, msg):
    srv, *_ = served
    code, text = call(srv, "/v1/completions", body)
    assert code == 400 and msg in json.loads(text)["error"]["message"]


def test_unreachable_kv_source_falls_back_locally(served):
    """A ``kubeinfer_kv_source`` that does not answer: the request
    prefills locally on the continuous route, with the engine's own
    tokens, and the fallback is counted by its reason (blocks of 16 here,
    so the prompt has full blocks to fetch)."""
    _srv, engine, _cont = served
    cont = ContinuousEngine(engine.params, CFG, n_slots=2, cache_len=64,
                            block_size=16, device="cpu").start()
    srv = ts.InferenceServer(engine, "tiny", port=0, continuous=cont,
                             device="cpu").start()
    try:
        prompt = list(range(3, 40))  # two full blocks of 16
        code, body = call(srv, "/v1/completions", dict(
            prompt=prompt, max_tokens=4,
            kubeinfer_kv_source="http://127.0.0.1:9"))
        resp = json.loads(body)
        assert code == 200 and resp["kubeinfer"]["route"] == "continuous"
        assert resp["choices"][0]["tokens"] == cont.generate(prompt, 4)
        assert [ln for ln in srv.registry.render().splitlines()
                if ln.startswith("kubeinfer_disagg_fallbacks_total")] == [
            'kubeinfer_disagg_fallbacks_total{reason="fetch_error"} 1']
        assert cont.imports_total == 0
    finally:
        srv.stop()
        cont.stop()


@pytest.mark.parametrize("flags,msg", [
    (["--speculative-draft"], "speculative"),
    # these three ids named flags that waited for a ROADMAP entry; the
    # sequence-parallel flags are served now (tests/test_torch_sp.py),
    # and what the server refuses of them exits with its reason
    pytest.param(["--tensor-parallel-size", "2", "--sequence-parallel-size",
                  "2", "--weight-dtype", "int8"],
                 "--weight-dtype int8 does not compose with "
                 "--sequence-parallel-size > 1 yet", id="flags1-sharding.py"),
    pytest.param(["--sequence-parallel-size", "2", "--weight-dtype", "int8"],
                 "does not compose", id="flags2-debug endpoints"),
    pytest.param(["--sequence-parallel-size", "0", "--sp-min-prompt", "64"],
                 "--sequence-parallel-size must be >= 1",
                 id="flags3-debug endpoints"),
])
def test_main_refuses_waiting_flags(flags, msg):
    """Flag combinations the server refuses exit with the reference's
    reason: ``--weight-dtype int8`` with sequence parallelism, an sp
    size below 1, ``--speculative-draft`` without the ``--draft-model``
    it runs."""
    with pytest.raises(SystemExit, match=msg):
        ts.build_server(["--model", "tiny", "--random-init", *flags],
                        device="cpu")


@pytest.mark.parametrize("flags", [
    ["--kv-dtype", "int8"], ["--weight-dtype", "int8"],
    ["--kv-dtype", "int8", "--weight-dtype", "int8"]],
    ids=["kv", "weight", "both"])
def test_main_builds_quantized(flags):
    """The precision flags build their engines on the CPU, and a
    completion rides the continuous route on them."""
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0",
         "--batch-slots", "2", "--max-model-len", "128", *flags],
        device="cpu")
    kv = "int8" if "--kv-dtype" in flags else "bf16"
    w = "int8" if "--weight-dtype" in flags else "bf16"
    assert (cont.kv_dtype, cont.weight_dtype) == (kv, w)
    assert isinstance(srv.engine.params["layers"][0]["q_proj"], dict) == (
        w == "int8")
    cont.start()
    srv.start()
    try:
        code, body = call(srv, "/v1/completions",
                          dict(prompt=[3, 1, 4, 1, 5], max_tokens=4))
        resp = json.loads(body)
        assert code == 200 and resp["kubeinfer"]["route"] == "continuous"
        assert len(resp["choices"][0]["tokens"]) == 4
    finally:
        srv.stop()
        cont.stop()
    with pytest.raises(SystemExit):
        ts.build_server(["--model", "tiny", "--random-init",
                         "--kv-dtype", "fp8"], device="cpu")


def test_main_builds_the_cpu_rehearsal():
    # without --random-init, --model names a checkpoint directory
    with pytest.raises(FileNotFoundError, match="config.json"):
        ts.build_server(["--model", "tiny"], device="cpu")
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0",
         "--batch-slots", "2", "--dtype", "float32"], device="cpu")
    try:
        assert cont.n_slots == 2 and cont.cache_len == 512
        assert cont.chunk_tokens == 4 * 128
        assert srv.engine.max_cache_len == CFG.max_position_embeddings
    finally:
        srv.stop()


def test_random_init_falls_back_to_tiny():
    """``--random-init`` with a ``--model`` that is not a preset (the
    agent passes its model cache directory) serves ``tiny``, as the
    reference does."""
    srv, cont = ts.build_server(
        ["--model", "/tmp/model-cache-dir", "--random-init", "--port", "0",
         "--batch-slots", "0"], device="cpu")
    try:
        assert cont is None and srv.engine.cfg == PRESETS["tiny"]
        assert srv.model_id == "/tmp/model-cache-dir"
    finally:
        srv.stop()


def test_server_needs_cuda_by_default(served, monkeypatch):
    _, engine, _ = served
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.InferenceServer(engine, "tiny", port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.build_server(["--model", "tiny", "--random-init", "--port", "0"])


def test_speculative_flags_build_and_route():
    """``--draft-model`` (seeded 1) builds a SpeculativeEngine: with
    ``--batch-slots 0`` a draft-eligible request takes the "speculative"
    route, as the reference routes it, with that engine's tokens; a
    repetition penalty falls through to the engine route."""
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0",
         "--batch-slots", "0", "--draft-model", "tiny",
         "--speculation-depth", "3"], device="cpu")
    spec = srv.speculative
    assert cont is None and spec.k == 3 and spec.draft_cfg == CFG
    # seeded 1, as the reference's PRNGKey(1) draft
    assert torch.equal(spec.draft_params["embed_tokens"],
                       init_params(CFG, seed=1, dtype=torch.bfloat16,
                                   device="cpu")["embed_tokens"])
    srv.start()
    try:
        prompt = [3, 1, 4, 1, 5]
        for kw, route in (({}, "speculative"),
                          (dict(temperature=0.7, seed=2), "speculative"),
                          (dict(repetition_penalty=1.2), "engine")):
            code, body = call(srv, "/v1/completions",
                              dict(prompt=prompt, max_tokens=6, **kw))
            resp = json.loads(body)
            assert code == 200 and resp["kubeinfer"]["route"] == route
            if route == "speculative":
                out = spec.generate([prompt], 6, **kw)
                assert resp["choices"][0]["tokens"] == out.tokens[0].tolist()
    finally:
        srv.stop()


@pytest.mark.parametrize("verify", [False, True], ids=["groups", "verify"])
def test_batcher_owns_draft_traffic(verify):
    """With slots, the batcher owns the draft-eligible requests it fits:
    its draft groups, or with ``--speculative-draft`` its verify windows
    (whose per-request accounting rides the request's engine.decode span,
    as in the reference; the response's ``kubeinfer`` object is the
    reference's)."""
    flags = ["--model", "tiny", "--random-init", "--port", "0",
             "--batch-slots", "2", "--max-model-len", "128",
             "--draft-model", "tiny", "--prewarm-spec", "1,2"]
    srv, cont = ts.build_server(flags + (["--speculative-draft"] if verify
                                         else []), device="cpu")
    assert cont.speculative is srv.speculative
    assert (cont.spec_draft is not None) == verify and cont.spec_k == 4
    cont.start()
    srv.start()
    try:
        code, body = call(srv, "/v1/completions",
                          dict(prompt=[3, 1, 4, 1, 5], max_tokens=6))
        resp = json.loads(body)
        assert code == 200 and resp["kubeinfer"]["route"] == "continuous"
        assert len(resp["choices"][0]["tokens"]) == 6
        assert sorted(resp["kubeinfer"]) == ["route", "tpot_ms", "ttft_ms"]
        rid = int(resp["id"].rsplit("-", 1)[1])
        code, body = call(srv, "/debug/spans")
        events = json.loads(body)["traceEvents"]
        spans = [e for e in events if e.get("name") == "engine.decode"
                 and e.get("args", {}).get("req") == rid]
        assert code == 200
        if verify:
            # a slot's decode span, with the verify accounting
            assert len(spans) == 1
            assert "kubeinfer.spec_accepted" in spans[0]["args"]
        else:
            # a draft group's residency is one engine.spec_group span
            assert not spans
            assert any(e.get("name") == "engine.spec_group" for e in events)
        if verify:
            assert cont.scheduler_stats()["spec_draft_tokens"] > 0
        else:
            assert cont.spec_served == 1
    finally:
        srv.stop()
        cont.stop()


def test_draft_directory_waits_for_load_pretrained(tmp_path):
    """With ``--random-init`` the draft must name a preset, as in the
    reference; a draft directory loads without it
    (``tests/test_torch_load.py``)."""
    with pytest.raises(SystemExit, match="is not a preset"):
        ts.build_server(["--model", "tiny", "--random-init",
                         "--draft-model", str(tmp_path)], device="cpu")
