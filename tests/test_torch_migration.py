"""Drain and live-session migration of the port (``ContinuousEngine.drain``,
``submit(resume_tokens=...)``, the migration sink, the server's ``POST
/admin/drain`` and ``kubeinfer_resume`` route) against the JAX package's,
on the CPU, ``tiny`` with blocks of 16 and the reference's parameters
carried across (``weights.params_from_reference``).

The cases follow ``tests/test_migration.py::TestEngineDrain`` and
``TestServerDrain``:

- An idle drain refuses new work and ``undrain()`` recovers; the
  ``resume_tokens`` checks refuse what the reference refuses.
- A session drained mid-decode streams its committed chain chunk by chunk
  (wire v1/v2 for chunk 0, v3 after, byte-compatible between the
  packages), and a target that chain-imports it finishes the session
  with EXACTLY the uninterrupted stream (f32, greedy and sampled, bf16
  and int8 pools): port to port, port chunks resumed by the JAX engine,
  and JAX chunks resumed by the port's.
- A bounce-back resume lands warm on the source; a drain with no sink
  degrades to a re-prefill resume; a broken sink falls forward; a chunk
  on a missing prefix is rejected; an int8 session streams v2 and v3
  with scales.
- Over HTTP between two port servers: drain, migrate, resume; 503
  ``draining``; ``{"resume": true}`` undrains; a degenerate tail answers
  directly.

No sleep stands in for synchronisation: a source engine holds its
scheduler at a window boundary once the session has decoded a few
tokens (``gated``) until the drain is flagged, so the drain always wins
against the session's budget, and every wait has its own timeout.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kubeinfer_tpu.disagg import client as jclient
from kubeinfer_tpu.disagg import wire as jwire
from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import batching as jb
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu_torch.disagg import client as tclient
from kubeinfer_tpu_torch.disagg import wire as twire
from kubeinfer_tpu_torch.inference import batching as tb
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.kv_blocks import prefix_fingerprints

JT, TT = JP["tiny"], TP["tiny"]
BS = 16
NEW = 64
WAIT_S = 120  # a hung scheduler fails the test instead of the run
PKG = {"jax": (jb, jwire, jclient), "port": (tb, twire, tclient)}


@pytest.fixture(scope="module")
def params():
    p = j_init(JT, jax.random.PRNGKey(0))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def gated(cls, min_tokens):
    """``cls`` whose scheduler, at the first window boundary where a slot
    has decoded ``min_tokens`` tokens, sets ``ready`` and waits for
    ``go`` (which ``drain_when_ready`` sets right after the drain flag):
    the drain then starts with the session far from its budget."""

    class Gated(cls):
        def _maybe_preempt(self):
            super()._maybe_preempt()
            if self.go.is_set():
                return
            if any(r is not None and len(r.out_tokens) >= min_tokens
                   for r in self._slot_req):
                self.ready.set()
                self.go.wait(WAIT_S)

    return Gated


def engine(pkg, params, min_tokens=None, **kw):
    kw = dict(n_slots=2, cache_len=128, block_size=BS, **kw)
    cls = PKG[pkg][0].ContinuousEngine
    if min_tokens is not None:
        cls = gated(cls, min_tokens)
    eng = (cls(params[0], JT, **kw) if pkg == "jax" else
           cls(params[1], TT, device="cpu", **kw))
    eng.ready, eng.go = threading.Event(), threading.Event()
    return eng.start()


def drain_when_ready(eng):
    assert eng.ready.wait(WAIT_S), "the session never decoded"
    eng.drain()
    eng.go.set()


def wait_for(cond, timeout=WAIT_S):
    """Poll ``cond`` every 2 ms until it holds or ``timeout`` passes."""
    ev = threading.Event()
    for _ in range(int(timeout / 0.002)):
        if cond():
            return True
        ev.wait(0.002)
    return False


def prompt_tokens(n, seed=11):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def blob_sink(wire, blobs: dict):
    """A migration sink that wire-encodes each chunk and keys it by the
    chunk's deepest fingerprint, as the server's export cache does."""

    def sink(chunk):
        blobs[int(chunk["fingerprints"][-1])] = wire.encode_payload(
            chunk["pages_k"], chunk["pages_v"], chunk["fingerprints"],
            chunk["block_size"], scales_k=chunk.get("scales_k"),
            scales_v=chunk.get("scales_v"),
            kv_dtype=chunk.get("kv_dtype", "bf16"),
            start_block=chunk["start_block"])

    return sink


def drain_session(eng, prompt, sampling, new=NEW):
    """Submit, drain once the session decoded a few tokens, and return the
    request, which must have migrated."""
    req = eng.submit(prompt, new, eos_id=-1, **sampling)
    drain_when_ready(eng)
    assert eng.wait_drained(WAIT_S)
    assert req.done.wait(WAIT_S)
    assert req.migrated is not None and not req.failed
    return req


def uninterrupted(pkg, params, prompt, sampling, kv="bf16"):
    eng = engine(pkg, params, kv_dtype=kv)
    try:
        return eng.generate(prompt, NEW, eos_id=-1, timeout=WAIT_S,
                            **sampling)
    finally:
        eng.stop()


# --- the engine --------------------------------------------------------------


def test_drain_idle_refuses_and_undrain_recovers(params):
    eng = engine("port", params)
    try:
        assert not eng.draining
        eng.drain()
        eng.drain()  # idempotent
        assert eng.draining and eng.wait_drained(10.0)
        with pytest.raises(tb.EngineDrainingError):
            eng.submit(prompt_tokens(8))
        eng.undrain()
        assert not eng.draining
        assert len(eng.generate(prompt_tokens(8), 2, timeout=WAIT_S)) == 2
    finally:
        eng.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case,match", [
    (dict(max_new_tokens=4, resume_tokens=[1, 2, 3, 4]), "budget"),
    # 40 + 30 pads to the 128 bucket, wider than a 96-wide row
    (dict(max_new_tokens=56, resume_tokens=list(range(30))), "resume bucket"),
])
def test_resume_tokens_validation(params, pkg, case, match):
    mod = PKG[pkg][0]
    kw = dict(n_slots=2, cache_len=96, block_size=BS)
    eng = (mod.ContinuousEngine(params[0], JT, **kw) if pkg == "jax" else
           mod.ContinuousEngine(params[1], TT, device="cpu", **kw))
    with pytest.raises(ValueError, match=match):
        eng.submit(prompt_tokens(40), **case)
    eng.stop()


MIGRATION_CASES = [
    pytest.param("bf16", {}, id="bf16-greedy"),
    pytest.param("bf16", {"temperature": 0.8, "top_p": 0.9, "seed": 7},
                 id="bf16-sampled"),
    pytest.param("int8", {}, id="int8-greedy"),
]


@pytest.mark.parametrize("src,dst", [("port", "port"), ("port", "jax"),
                                     ("jax", "port")])
@pytest.mark.parametrize("kv,sampling", MIGRATION_CASES)
def test_migrated_session_resumes_token_identical(params, monkeypatch, src,
                                                  dst, kv, sampling):
    """The source drains mid-decode and streams its committed chain one
    block a chunk; the target chain-imports it through its own package's
    client and finishes the session with EXACTLY the uninterrupted
    stream of both packages."""
    p = prompt_tokens(40, seed=51)
    expect = uninterrupted(dst, params, p, sampling, kv)
    if src != dst:
        assert expect == uninterrupted(src, params, p, sampling, kv)
    blobs: dict = {}
    a = engine(src, params, min_tokens=3, kv_dtype=kv,
               migration_chunk_blocks=1)
    try:
        a.migration_sink = blob_sink(PKG[src][1], blobs)
        req = drain_session(a, p, sampling)
    finally:
        a.stop()
    mig = req.migrated
    toks = mig["tokens"]
    assert toks == req.out_tokens and 3 <= len(toks) < NEW
    assert toks == expect[:len(toks)]  # no token lost at the source
    chain = (p + toks)[:-1]
    fps = prefix_fingerprints(chain, BS)
    assert (mig["blocks"], mig["block_size"], mig["kv_dtype"]) == \
        (len(fps), BS, kv)
    assert (a.migrated_total, a.migration_chunks_total,
            a.migration_blocks_total) == (1, len(fps), len(fps))
    assert set(blobs) == set(fps)  # every chunk addressable

    wire, client = PKG[dst][1], PKG[dst][2]
    monkeypatch.setattr(client, "fetch_kv_blocks",
                        lambda base, fp, timeout_s=0, rng=None:
                        wire.decode_payload(blobs[int(fp)]))
    b = engine(dst, params, kv_dtype=kv, migration_chunk_blocks=1)
    try:
        n, reason, nbytes = client.import_remote_chain(
            b, chain, "http://unused", chunk_blocks=1)
        assert (n, reason) == (len(fps), None) and nbytes > 0
        out = b.serve(p, NEW, eos_id=-1, resume_tokens=toks,
                      timeout=WAIT_S, **sampling).out_tokens
        stats = b.kv_cache_stats()
    finally:
        b.stop()
    assert out == expect  # the full answer, the resume prefix included
    assert stats["hits"] >= 1  # the resume admit matched the chain


def test_bounce_back_resume_lands_warm_locally(params):
    """The session returns to the source after undrain: the park left the
    committed blocks in the trie, so the resume matches them (no import,
    no re-prefill of the streamed prefix) with the same tokens."""
    p = prompt_tokens(40, seed=52)
    expect = uninterrupted("port", params, p, {})
    a = engine("port", params, min_tokens=3, migration_chunk_blocks=1)
    try:
        a.migration_sink = blob_sink(twire, {})
        toks = drain_session(a, p, {}).migrated["tokens"]
        hits = a.kv_cache_stats()["hits"]
        a.undrain()
        out = a.serve(p, NEW, eos_id=-1, resume_tokens=toks,
                      timeout=WAIT_S).out_tokens
        assert out == expect and a.imports_total == 0
        assert a.kv_cache_stats()["hits"] > hits
        # the resume admit counts as a readmit, as the reference counts it
        stats = a.scheduler_stats()
        assert (stats["preempted"], stats["resumed"]) == (0, 1)
    finally:
        a.stop()


def test_no_sink_drain_degrades_to_reprefill_resume(params):
    p = prompt_tokens(40, seed=53)
    expect = uninterrupted("port", params, p, {})
    a = engine("port", params, min_tokens=3)  # migration_sink stays None
    try:
        req = drain_session(a, p, {})
        assert req.migrated["blocks"] == 0 and a.migration_chunks_total == 0
    finally:
        a.stop()
    b = engine("port", params)
    try:
        out = b.serve(p, NEW, eos_id=-1, resume_tokens=req.migrated["tokens"],
                      timeout=WAIT_S).out_tokens
        assert out == expect and b.imports_total == 0
    finally:
        b.stop()


def test_broken_sink_falls_forward_not_wedged(params):
    a = engine("port", params, min_tokens=3, migration_chunk_blocks=1)
    try:
        def sink(chunk):
            raise RuntimeError("sink down")

        a.migration_sink = sink
        req = drain_session(a, prompt_tokens(40, seed=54), {})
        assert req.migrated["blocks"] == 0
        assert a.migration_chunks_total == 0
    finally:
        a.stop()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_chunk_on_missing_prefix_is_rejected(params, pkg):
    """A v3 chunk stacks only on the exact prefix it continues."""
    p = prompt_tokens(40, seed=55)
    a = engine(pkg, params)
    try:
        exp = a.serve(p, 0, eos_id=-1, export_kv=True,
                      timeout=WAIT_S).kv_export
    finally:
        a.stop()
    b = engine(pkg, params)
    try:
        n, reason = b.import_prefix(p[:2 * BS], exp["pages_k"][:, 1:2],
                                    exp["pages_v"][:, 1:2], start_block=1)
        assert (n, reason) == (0, "missing_prefix")
        assert b.imports_total == 0
    finally:
        b.stop()


def test_parked_and_queued_requests_migrate_unstreamed(params):
    """Requests waiting when the drain starts (queued behind the two
    slots) complete as migrated with no blocks and their (empty) output,
    and the stopped engine fails nothing."""
    a = engine("port", params, min_tokens=3, migration_chunk_blocks=1)
    try:
        a.migration_sink = blob_sink(twire, {})
        reqs = [a.submit(prompt_tokens(20, seed=60 + i), NEW, eos_id=-1)
                for i in range(4)]
        drain_when_ready(a)
        assert a.wait_drained(WAIT_S)
        for r in reqs:
            assert r.done.wait(WAIT_S) and r.migrated is not None
        waiting = [r for r in reqs if not r.migrated["tokens"]]
        assert len(waiting) >= 2
        assert all(r.migrated["blocks"] == 0 for r in waiting)
        assert a.migrated_total == 4
        assert a.scheduler_stats()["parked"] == 0
    finally:
        a.stop()
    assert not any(r.failed for r in reqs)


def test_int8_session_streams_v2_then_v3_with_scales(params):
    p = prompt_tokens(40, seed=56)
    blobs: dict = {}
    a = engine("port", params, min_tokens=3, kv_dtype="int8",
               migration_chunk_blocks=1)
    try:
        a.migration_sink = blob_sink(twire, blobs)
        toks = drain_session(a, p, {}).migrated["tokens"]
    finally:
        a.stop()
    fps = prefix_fingerprints((p + toks)[:-1], BS)
    assert len(fps) >= 2
    for i, fp in enumerate(fps):
        blob = blobs[fp]
        header = json.loads(blob[:blob.find(b"\n")])
        pay = twire.decode_payload(blob)
        ref = jwire.decode_payload(blob)  # the reference reads it too
        assert header["magic"].endswith("/2" if i == 0 else "/3")
        assert pay.start_block == ref.start_block == i
        assert pay.kv_dtype == "int8" and pay.pages_k.dtype == torch.int8
        assert tuple(pay.scales_k.shape) == (TT.num_hidden_layers, 1,
                                             TT.num_key_value_heads)
        np.testing.assert_array_equal(pay.scales_v.numpy(), ref.scales_v)


# --- two port servers over HTTP ----------------------------------------------


@pytest.fixture(scope="module")
def pair(params):
    servers = []
    for name in ("src", "dst"):
        cont = engine("port", params, min_tokens=2 if name == "src" else None,
                      migration_chunk_blocks=1)
        srv = ts.InferenceServer(Engine(params[1], TT, device="cpu"), name,
                                 port=0, continuous=cont,
                                 device="cpu").start()
        servers.append((srv, cont))
    yield servers
    for srv, cont in servers:
        srv.stop()
        cont.stop()


def post(srv, body, path="/v1/completions"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT_S) as r:
        return r.status, json.loads(r.read())


def test_drain_migrate_resume_roundtrip(pair, params):
    (src, src_cont), (dst, dst_cont) = pair
    p = prompt_tokens(40, seed=61)
    n_new = 48
    ref = engine("port", params)
    try:
        expect = ref.generate(p, n_new, eos_id=-1, timeout=WAIT_S)
    finally:
        ref.stop()
    result = {}

    def client():
        result["status"], result["doc"] = post(
            src, {"prompt": p, "max_tokens": n_new})

    t = threading.Thread(target=client)
    t.start()
    assert src_cont.ready.wait(WAIT_S)
    report = {}
    drainer = threading.Thread(target=lambda: report.update(
        post(src, {}, "/admin/drain")[1]))
    drainer.start()
    # the drain flag is up once the server called drain(); then the
    # session may move again
    assert wait_for(lambda: src_cont.draining)
    src_cont.go.set()
    drainer.join(WAIT_S)
    t.join(WAIT_S)
    assert not drainer.is_alive() and not t.is_alive()
    assert report["drained"] and report["draining"]
    assert report["migrated"] == 1
    assert report["migration_chunks_total"] >= 1
    assert report["exports"]["entries"] >= 1
    assert result["status"] == 200
    doc = result["doc"]
    assert doc["choices"][0]["finish_reason"] == "migrated"
    mig = doc["kubeinfer"]["migrated"]
    toks = mig["tokens"]
    assert doc["choices"][0]["tokens"] == toks == expect[:len(toks)]
    assert mig["blocks"] >= 1

    # a draining replica answers new work 503 "draining", no Retry-After
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(src, {"prompt": p, "max_tokens": 2})
    assert ei.value.code == 503 and "Retry-After" not in ei.value.headers
    assert json.loads(ei.value.read())["error"]["type"] == "draining"

    # resume on the target, chain-importing from the source
    status, doc = post(dst, {
        "prompt": p, "max_tokens": n_new,
        "kubeinfer_resume": {"tokens": toks,
                             "kv_source": f"http://127.0.0.1:{src.port}"}})
    assert status == 200 and doc["kubeinfer"]["route"] == "resume"
    assert doc["choices"][0]["tokens"] == expect
    assert doc["choices"][0]["finish_reason"] == "length"
    assert dst_cont.imports_total >= 1
    assert dst.kv_stream_blocks["import"] >= mig["blocks"]
    assert not dst.migration_fallbacks
    assert src.kv_stream_blocks["export"] >= mig["blocks"]

    # rebalance epilogue: {"resume": true} rejoins the fleet
    status, report = post(src, {"resume": True}, "/admin/drain")
    assert status == 200 and report["drained"] and not report["draining"]
    status, doc = post(src, {"prompt": p, "max_tokens": 2})
    assert status == 200 and len(doc["choices"][0]["tokens"]) == 2


def test_resume_from_a_dead_source_counts_a_fallback(pair, params):
    """A kv_source that does not answer: the target re-prefills the
    session (the same tokens) and counts the reason."""
    _, (dst, dst_cont) = pair
    p = prompt_tokens(40, seed=62)
    expect = uninterrupted("port", params, p, {})
    status, doc = post(dst, {
        "prompt": p, "max_tokens": NEW,
        "kubeinfer_resume": {"tokens": expect[:5],
                             "kv_source": "http://127.0.0.1:9"}})
    assert status == 200 and doc["choices"][0]["tokens"] == expect
    assert dst.migration_fallbacks["fetch_error"] >= 1


def test_degenerate_tail_resume_answers_directly(pair):
    _, (dst, dst_cont) = pair
    resumed = dst_cont.scheduler_stats()
    status, doc = post(dst, {"prompt": prompt_tokens(8), "max_tokens": 3,
                             "kubeinfer_resume": {"tokens": [3, 4, 5, 6, 7]}})
    assert status == 200 and doc["kubeinfer"]["route"] == "resume"
    assert doc["choices"][0]["tokens"] == [3, 4, 5]
    assert dst_cont.scheduler_stats() == resumed  # no admit


@pytest.mark.parametrize("body", [b"not json", b"[1, 2]"])
def test_admin_drain_bad_body_counts_as_empty(params, body):
    """A body that is not a JSON object drains like ``{}``; a server
    without the continuous batcher answers 400."""
    cont = engine("port", params)
    srv = ts.InferenceServer(Engine(params[1], TT, device="cpu"), "t",
                             port=0, continuous=cont, device="cpu").start()
    bare = ts.InferenceServer(Engine(params[1], TT, device="cpu"), "b",
                              port=0, device="cpu").start()
    try:
        for server, code in ((srv, 200), (bare, 400)):
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.port}/admin/drain", data=body)
            try:
                with urllib.request.urlopen(req, timeout=WAIT_S) as r:
                    got, doc = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                got, doc = e.code, json.loads(e.read())
            assert got == code, doc
        assert doc["error"]["type"] == "invalid_request_error"
        assert cont.draining
    finally:
        srv.stop()
        bare.stop()
        cont.stop()


# --- on a card ---------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_drain_and_resume_on_card(kv):
    """Drain and resume on the card at tiny size (blocks of 16: the gather
    + dense decode route; the full-width path with its kernels is
    chip_smoke.py's phase 31): the streamed pages land bitwise, and the
    resumed stream equals an uninterrupted run on the same card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from kubeinfer_tpu_torch.inference.model import init_params

    dev = torch.device("cuda")
    p = init_params(TT, seed=3, device=dev)

    def mk(min_tokens=None):
        cls = tb.ContinuousEngine
        if min_tokens is not None:
            cls = gated(cls, min_tokens)
        eng = cls(p, TT, n_slots=2, cache_len=128, block_size=BS,
                  kv_dtype=kv, migration_chunk_blocks=1, device=dev)
        eng.ready, eng.go = threading.Event(), threading.Event()
        return eng.start()

    prompt = prompt_tokens(40, seed=57)
    ref = mk()
    try:
        expect = ref.generate(prompt, NEW, timeout=WAIT_S)
    finally:
        ref.stop()
    blobs: dict = {}
    a = mk(min_tokens=3)
    try:
        a.migration_sink = blob_sink(twire, blobs)
        toks = drain_session(a, prompt, {}).migrated["tokens"]
        chain = (prompt + toks)[:-1]
        src_blocks = a._radix.match(chain)
        a._pool.unref(src_blocks)
        src_pages = a._gather_pages(torch.tensor(src_blocks, device=dev))
    finally:
        a.stop()
    b = mk()
    try:
        for i, fp in enumerate(prefix_fingerprints(chain, BS)):
            pay = twire.decode_payload(blobs[fp])
            n, reason = b.import_prefix(
                chain[:(i + 1) * BS], pay.pages_k, pay.pages_v,
                scales_k=pay.scales_k, scales_v=pay.scales_v, kv_dtype=kv,
                start_block=i)
            assert (n, reason) == (1, None)
        dst_blocks = b._radix.match(chain)
        b._pool.unref(dst_blocks)
        dst_pages = b._gather_pages(torch.tensor(dst_blocks, device=dev))
        out = b.serve(prompt, NEW, resume_tokens=toks,
                      timeout=WAIT_S).out_tokens
    finally:
        b.stop()
    for key, t in src_pages.items():
        assert torch.equal(t, dst_pages[key]), key
    assert out == expect
