"""The port's disaggregated prefill/decode (``kubeinfer_tpu_torch.disagg``,
``ContinuousEngine.import_prefix``/``submit(export_kv=True)`` and the
server's ``max_tokens=0``, ``GET /kv/blocks`` and ``kubeinfer_kv_source``)
against the JAX package's, on the CPU, ``tiny`` with blocks of 16 and the
reference's parameters carried across (``weights.params_from_reference``).

- Wire: on the same pages, fingerprints and block size the port's blob is
  byte-for-byte the reference's (v1 f32 and bf16, v2 int8 + scales, v3),
  each package decodes the other's, and every corruption the reference
  rejects raises ``WireError`` in the port too.
- Export cache: one sequence of put/get calls gives equal stats.
- Engines: the prefill-only capture against the reference's (f32 pages
  within 1e-5; int8 codes within one step, scales within 1e-6 relative),
  blobs crossing both ways between the JAX and the port engines with
  greedy and sampled streams EQUAL to the cold streams of both, the
  rejections under the reference's labels.
- Client and server: two port servers on loopback, the reference's HTTP
  cases, every client fallback label equal to the reference client's.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kubeinfer_tpu.disagg import client as jclient
from kubeinfer_tpu.disagg import export as jexport
from kubeinfer_tpu.disagg import wire as jwire
from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu_torch.disagg import client as tclient
from kubeinfer_tpu_torch.disagg import export as texport
from kubeinfer_tpu_torch.disagg import wire as twire
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.kv_blocks import prefix_fingerprints

BS = 16
NEW = 6
SAMPLED = dict(temperature=0.8, seed=123)
PROMPT = np.random.default_rng(11).integers(0, 256, 70).tolist()  # 4 blocks
N = len(PROMPT) // BS
PAGE_ATOL = 1e-5  # f32 pages, port vs reference (the same f32 forward)


@pytest.fixture(scope="module")
def params():
    p = j_init(JP["tiny"], jax.random.PRNGKey(0))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def j_engine(params, **kw):
    kw = dict(n_slots=2, cache_len=128, block_size=BS, **kw)
    return JC(params[0], JP["tiny"], **kw).start()


def t_engine(params, **kw):
    kw = dict(n_slots=2, cache_len=128, block_size=BS, **kw)
    return TC(params[1], TP["tiny"], device="cpu", **kw).start()


def streams(eng):
    return (eng.generate(PROMPT, NEW, timeout=120),
            eng.generate(PROMPT, NEW, timeout=120, **SAMPLED))


@pytest.fixture(scope="module")
def ref(params):
    """Per kv dtype: the cold greedy and sampled streams of each package's
    engine, and each package's prefill-only export of PROMPT (a fresh
    engine each)."""
    out = {}
    for kv in ("bf16", "int8"):
        row = {}
        for name, mk in (("jax", j_engine), ("port", t_engine)):
            eng = mk(params, kv_dtype=kv)
            try:
                row[name + "_cold"] = streams(eng)
            finally:
                eng.stop()
            eng = mk(params, kv_dtype=kv)
            try:
                req = eng.serve(PROMPT, 0, export_kv=True, timeout=120)
                row[name + "_req"] = req
                row[name + "_in_use"] = eng.kv_cache_stats()["blocks_in_use"]
            finally:
                eng.stop()
        out[kv] = row
    return out


def encode(pkg, exp):
    return pkg.encode_payload(
        exp["pages_k"], exp["pages_v"], exp["fingerprints"],
        exp["block_size"], scales_k=exp.get("scales_k"),
        scales_v=exp.get("scales_v"), kv_dtype=exp.get("kv_dtype", "bf16"))


def host(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --- the wire ------------------------------------------------------------------


def pages(dtype, blocks=3, seed=0):
    rng = np.random.default_rng(seed)
    shape = (2, blocks, 4, 2, 8)
    if dtype == "int8":
        return [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(2)]


def as_port(a):
    """The same bytes as a torch tensor (bfloat16 through its bits)."""
    if a.dtype == np.dtype(ml_dtypes.bfloat16):
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def wire_case(case):
    """(reference arrays, encode kwargs) of one wire case."""
    kv = "int8" if case in ("v2", "v3") else "bf16"
    k, v = pages(kv)
    if case == "bf16":
        k, v = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
    kw = {}
    if kv == "int8":
        rng = np.random.default_rng(3)
        kw = dict(scales_k=rng.random((2, 3, 2)).astype(np.float32),
                  scales_v=rng.random((2, 3, 2)).astype(np.float32),
                  kv_dtype="int8")
    if case in ("v3", "v3_bf16"):
        kw["start_block"] = 5
    return (k, v), kw


WIRE_CASES = ["f32", "bf16", "v2", "v3", "v3_bf16"]


@pytest.mark.parametrize("case", WIRE_CASES)
def test_blob_bytes_equal_reference(case):
    (k, v), kw = wire_case(case)
    want = jwire.encode_payload(k, v, [1, 2, 3], 4, **kw)
    tkw = {key: as_port(x) if isinstance(x, np.ndarray) else x
           for key, x in kw.items()}
    got = twire.encode_payload(as_port(k), as_port(v), [1, 2, 3], 4, **tkw)
    assert got == want
    magic = {"v2": b"/2", "v3": b"/3", "v3_bf16": b"/3"}.get(case, b"/1")
    assert got.split(b"\n", 1)[0].startswith(
        b'{"magic": "kubeinfer-kvwire' + magic)
    # numpy arrays of standard dtypes encode the same bytes
    if case != "bf16":
        assert twire.encode_payload(k, v, [1, 2, 3], 4, **kw) == want


@pytest.mark.parametrize("case", WIRE_CASES)
def test_each_side_decodes_the_others_blob(case):
    (k, v), kw = wire_case(case)
    blob = jwire.encode_payload(k, v, [1, 2, 3], 4, **kw)
    p = twire.decode_payload(blob)
    q = jwire.decode_payload(blob)
    assert isinstance(p.pages_k, torch.Tensor) and p.pages_k.device.type == "cpu"
    for got, want in ((p.pages_k, k), (p.pages_v, v)):
        assert np.array_equal(host(got.view(torch.int16) if got.dtype ==
                                   torch.bfloat16 else got),
                              want.view(np.int16) if want.dtype ==
                              np.dtype(ml_dtypes.bfloat16) else want)
    assert (p.fingerprints, p.block_size, p.kv_dtype, p.start_block,
            p.blocks, p.byte_size) == (
        q.fingerprints, q.block_size, q.kv_dtype, q.start_block, q.blocks,
        q.byte_size)
    if "scales_k" in kw:
        assert np.array_equal(host(p.scales_k), kw["scales_k"])
        assert np.array_equal(host(p.scales_v), kw["scales_v"])
    else:
        assert p.scales_k is None and p.scales_v is None
    # and the reference decodes the port's blob to the same arrays
    back = jwire.decode_payload(twire.encode_payload(
        p.pages_k, p.pages_v, p.fingerprints, p.block_size,
        scales_k=p.scales_k, scales_v=p.scales_v, kv_dtype=p.kv_dtype,
        start_block=p.start_block))
    assert np.array_equal(back.pages_k.view(np.uint8), q.pages_k.view(np.uint8))
    assert back.start_block == q.start_block


def _forge(blob, **hdr_changes):
    nl = blob.find(b"\n")
    hdr = json.loads(blob[:nl])
    hdr.update(hdr_changes)
    return json.dumps(hdr).encode() + blob[nl:]


def _flip(blob, at):
    b = bytearray(blob)
    b[at] ^= 0x10
    return bytes(b)


def corrupt(case):
    f32 = jwire.encode_payload(*pages("f32"), [1, 2, 3], 4)
    k8, v8 = pages("int8")
    sk = np.ones((2, 3, 2), np.float32)
    v2 = jwire.encode_payload(k8, v8, [1, 2, 3], 4, scales_k=sk,
                              scales_v=sk, kv_dtype="int8")
    v3 = jwire.encode_payload(k8, v8, [1, 2, 3], 4, scales_k=sk,
                              scales_v=sk, kv_dtype="int8", start_block=2)
    return {
        "checksum": (_flip(f32, -10), "checksum"),
        "scale_checksum": (_flip(v2, -3), "checksum"),
        "truncated": (f32[:-5], "truncated"),
        "magic": (b'{"magic": "nope"}\nxxxx', "magic"),
        "no_header": (b"no newline anywhere", "header"),
        "not_json": (b"{nope\nxx", "JSON"),
        "header_shape": (_forge(f32, blocks=2, fingerprints=[1, 2]),
                         "header shapes imply"),
        "v2_claims_bf16": (_forge(v2, kv_dtype="bf16"), "bf16"),
        "v3_zero_offset": (_forge(v3, start_block=0), "start_block"),
        "dtype": (_forge(f32, dtype="bogus"), "dtype"),
    }[case]


@pytest.mark.parametrize("case", [
    "checksum", "scale_checksum", "truncated", "magic", "no_header",
    "not_json", "header_shape", "v2_claims_bf16", "v3_zero_offset", "dtype"])
def test_corruption_raises_wire_error_on_both_sides(case):
    blob, match = corrupt(case)
    with pytest.raises(jwire.WireError, match=match):
        jwire.decode_payload(blob)
    with pytest.raises(twire.WireError, match=match):
        twire.decode_payload(blob)


@pytest.mark.parametrize("case,match", [
    ("fingerprints", "fingerprints"), ("disagree", "disagree"),
    ("layers", "layers"), ("together", "together"),
    ("no_scales", "inconsistent"), ("stray_scales", "inconsistent"),
    ("f64_scales", "float32"), ("negative_offset", "start_block")])
def test_encode_validates_like_reference(case, match):
    k, v = pages("int8")
    sk = np.ones((2, 3, 2), np.float32)
    args, kw = {
        "fingerprints": ((k, v, [1, 2]), {}),
        "disagree": ((k, v[:, :2], [1, 2, 3]), {}),
        "layers": ((k[0], v[0], [1, 2, 3]), {}),
        "together": ((k, v, [1, 2, 3]), dict(scales_k=sk, kv_dtype="int8")),
        "no_scales": ((k, v, [1, 2, 3]), dict(kv_dtype="int8")),
        "stray_scales": ((k, v, [1, 2, 3]), dict(scales_k=sk, scales_v=sk)),
        "f64_scales": ((k, v, [1, 2, 3]), dict(
            scales_k=sk.astype(np.float64), scales_v=sk, kv_dtype="int8")),
        "negative_offset": ((k, v, [1, 2, 3]), dict(start_block=-1)),
    }[case]
    for pkg in (jwire, twire):
        with pytest.raises(pkg.WireError, match=match):
            pkg.encode_payload(*args, 4, **kw)


# --- the export cache ---------------------------------------------------------


@pytest.mark.parametrize("budget", [None, 10])
def test_export_cache_stats_equal_reference(budget):
    caches = [jexport.KVExportCache(capacity=3, max_bytes=budget),
              texport.KVExportCache(capacity=3, max_bytes=budget)]
    ops = [("put", 1, b"one"), ("put", 2, b"two"), ("get", 1),
           ("put", 3, b"three"), ("put", 1, b"uno"), ("get", 2),
           ("put", 4, b"x" * 25),  # larger than the whole budget: kept once
           ("get", 4), ("get", 3), ("put", 5, b"five"), ("get", 1),
           ("get", 9)]
    outs = []
    for c in caches:
        seen = []
        for op in ops:
            if op[0] == "put":
                c.put(op[1], op[2])
            else:
                seen.append(c.get(op[1]))
        outs.append((seen, c.stats(), len(c)))
    assert outs[1] == outs[0]
    assert outs[1][1]["evictions"] > 0
    with pytest.raises(ValueError):
        texport.KVExportCache(capacity=0)
    with pytest.raises(ValueError):
        texport.KVExportCache(max_bytes=0)


# --- the engines ---------------------------------------------------------------


def test_cold_streams_agree(ref):
    for kv in ("bf16", "int8"):
        assert ref[kv]["port_cold"] == ref[kv]["jax_cold"]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_only_capture_matches_reference(ref, kv):
    row = ref[kv]
    jreq, treq = row["jax_req"], row["port_req"]
    assert treq.out_tokens == [] == jreq.out_tokens
    te, je = treq.kv_export, jreq.kv_export
    assert te["fingerprints"] == prefix_fingerprints(PROMPT, BS) == \
        je["fingerprints"]
    assert (te["block_size"], te["kv_dtype"]) == (BS, kv)
    # the walk's references went back: the trie alone holds the blocks
    assert row["port_in_use"] == N == row["jax_in_use"]
    for side in ("pages_k", "pages_v"):
        got, want = host(te[side]), np.asarray(je[side])
        assert got.shape == want.shape == (2, N, BS, 2, 16)
        if kv == "int8":
            assert got.dtype == np.int8
            assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=PAGE_ATOL)
    if kv == "int8":
        for side in ("scales_k", "scales_v"):
            np.testing.assert_allclose(host(te[side]), je[side], rtol=1e-6)


def test_no_export_without_flag_or_full_block(params):
    eng = t_engine(params)
    try:
        assert eng.serve(PROMPT[:40], 0, timeout=60).kv_export is None
        req = eng.serve(PROMPT[:BS - 1], 0, export_kv=True, timeout=60)
        assert req.kv_export is None and req.out_tokens == []
    finally:
        eng.stop()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax",
                                       "port_to_port"])
def test_imported_blob_gives_the_cold_streams(params, ref, kv, direction):
    """THE disaggregation contract across packages: decode over imported
    blocks equals decode over a cold local prefill, greedy and sampled."""
    src, dst = direction.split("_to_")
    exp = ref[kv][src + "_req"].kv_export
    blob = encode(jwire if src == "jax" else twire, exp)
    payload = (jwire if dst == "jax" else twire).decode_payload(blob)
    eng = (j_engine if dst == "jax" else t_engine)(params, kv_dtype=kv)
    try:
        n, reason = eng.import_prefix(
            PROMPT[:N * BS], payload.pages_k, payload.pages_v,
            scales_k=payload.scales_k, scales_v=payload.scales_v,
            kv_dtype=payload.kv_dtype)
        assert (n, reason) == (N, None)
        assert (eng.imports_total, eng.imported_blocks_total) == (1, N)
        assert eng.scheduler_stats()["kv_imported_blocks"] == N
        hits = eng.kv_cache_stats()["hits"]
        got = streams(eng)
        assert eng.kv_cache_stats()["hits"] == hits + 2
    finally:
        eng.stop()
    assert got == ref[kv]["jax_cold"] == ref[kv]["port_cold"]


def test_duplicate_import_dedups(params, ref):
    exp = ref["bf16"]["port_req"].kv_export
    eng = t_engine(params)
    try:
        for _ in range(2):
            assert eng.import_prefix(PROMPT[:N * BS], exp["pages_k"],
                                     exp["pages_v"]) == (N, None)
        assert eng.kv_cache_stats()["blocks_in_use"] == N
    finally:
        eng.stop()


def geometry(kv, n=1, n_kv=2, d=16):
    shape = (2, n, BS, n_kv, d)
    if kv == "int8":
        return (np.zeros(shape, np.int8),) * 2, dict(
            scales_k=np.ones((2, n, n_kv), np.float32),
            scales_v=np.ones((2, n, n_kv), np.float32), kv_dtype="int8")
    return (np.zeros(shape, np.float32),) * 2, {}


REJECTIONS = {
    # case: (engine kv dtype, tokens, pages kv dtype, geometry, extra kw)
    "wrong_geometry": ("bf16", 2 * BS, "bf16", dict(n=2, d=8), {}),
    "token_count": ("bf16", 3, "bf16", {}, {}),
    "negative_offset": ("bf16", BS, "bf16", {}, dict(start_block=-1)),
    "past_the_row": ("bf16", 9 * BS, "bf16", dict(n=9), {}),
    "missing_scales": ("int8", BS, "int8", {}, dict(scales_v=None)),
    "bf16_into_int8": ("int8", BS, "bf16", {}, {}),
    "int8_into_bf16": ("bf16", BS, "int8", {}, {}),
    "missing_prefix": ("bf16", 2 * BS, "bf16", {}, dict(start_block=1)),
    "backpressure": ("bf16", BS, "bf16", {}, {}),
    "timeout": ("bf16", BS, "bf16", {}, dict(timeout_s=0)),
    "stopped": ("bf16", BS, "bf16", {}, {}),
}
LABELS = {"bf16_into_int8": "kv_dtype_mismatch",
          "int8_into_bf16": "kv_dtype_mismatch",
          "missing_prefix": "missing_prefix", "backpressure": "backpressure",
          "timeout": "timeout", "stopped": "stopped"}


@pytest.mark.parametrize("case", sorted(REJECTIONS))
def test_import_rejections_match_reference(params, case):
    kv, ntok, pkv, geo, extra = REJECTIONS[case]
    (pk, pv), kw = geometry(pkv, **geo)
    kw.update(extra)
    tokens = list(range(ntok))
    got = []
    for mk in (j_engine, t_engine):
        eng = mk(params, kv_dtype=kv)
        held = []
        if mk is t_engine:  # the port takes CPU tensors
            pk, pv = torch.from_numpy(pk), torch.from_numpy(pv)
            kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                  for k, v in kw.items()}
        try:
            if case == "stopped":
                eng.stop()
            if case == "backpressure":
                held = eng._pool.alloc(eng._pool.free_blocks)
            got.append(eng.import_prefix(tokens, pk, pv, **kw))
            assert eng.imports_total == 0
        finally:
            if held:
                eng._pool.unref(held)
            eng.stop()
    assert got[1] == got[0] == (0, LABELS.get(case, "shape_mismatch"))


def test_chunked_import_stacks_on_its_base(params, ref):
    """Wire v3 through the engine: chunk [2, 4) lands on the blocks chunk
    [0, 2) inserted, and the streams are the cold ones."""
    exp = ref["bf16"]["port_req"].kv_export
    eng = t_engine(params)
    try:
        for lo, hi in ((0, 2), (2, 4)):
            assert eng.import_prefix(
                PROMPT[:hi * BS], exp["pages_k"][:, lo:hi],
                exp["pages_v"][:, lo:hi], start_block=lo) == (hi - lo, None)
        assert eng.kv_cache_stats()["blocks_in_use"] == N
        assert streams(eng) == ref["bf16"]["port_cold"]
    finally:
        eng.stop()


def test_staged_import_serviced_while_idle_and_released_at_stop(params, ref):
    exp = ref["bf16"]["port_req"].kv_export
    eng = t_engine(params)
    try:
        # nothing submitted: the loop sits in its idle branch
        assert eng.import_prefix(PROMPT[:N * BS], exp["pages_k"],
                                 exp["pages_v"], timeout_s=5) == (N, None)
    finally:
        eng.stop()
    # a task staged but never serviced is released by stop()
    eng = TC(params[1], TP["tiny"], n_slots=2, cache_len=128, block_size=BS,
             device="cpu")
    from kubeinfer_tpu_torch.inference.batching import _ImportTask

    task = _ImportTask(PROMPT[:BS], exp["pages_k"][:, :1],
                       exp["pages_v"][:, :1])
    eng._imports.append(task)
    eng.stop()
    assert task.done.is_set() and task.reason == "stopped"


# --- client and server ----------------------------------------------------------


@pytest.fixture(scope="module")
def fleet(params):
    """Two port servers on loopback, "pre" and "dec", each over its own
    continuous engine."""
    out = []
    for name in ("pre", "dec"):
        cont = t_engine(params)
        srv = ts.InferenceServer(
            Engine(params[1], TP["tiny"], max_cache_len=256, device="cpu"),
            name, port=0, continuous=cont, device="cpu").start()
        out.append((srv, cont))
    yield out
    for srv, cont in out:
        srv.stop()
        cont.stop()


def url(srv):
    return f"http://127.0.0.1:{srv.port}"


def post(srv, body):
    req = urllib.request.Request(
        url(srv) + "/v1/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


def prompt(seed, n=70):
    return np.random.default_rng(seed).integers(0, 256, n).tolist()


def test_prefill_only_then_kv_blocks_fetch(fleet):
    (pre, _), _ = fleet
    p = prompt(21)
    status, doc = post(pre, {"prompt": p, "max_tokens": 0})
    assert status == 200 and doc["kubeinfer"]["route"] == "prefill"
    assert doc["usage"]["completion_tokens"] == 0
    assert doc["choices"][0]["tokens"] == []
    ext = doc["kubeinfer"]["kv_export"]
    fps = prefix_fingerprints(p, BS)
    assert (ext["fingerprint"], ext["blocks"]) == (fps[-1], len(fps))
    before = pre.metrics["kv_stream_blocks"].value("export")
    payload = tclient.fetch_kv_blocks(url(pre), fps[-1])
    assert list(payload.fingerprints) == fps
    assert pre.metrics["kv_stream_blocks"].value("export") == before + len(fps)
    with urllib.request.urlopen(f"{url(pre)}/kv/blocks?fp={fps[-1]}",
                                timeout=10) as r:
        assert len(r.read()) == ext["bytes"]
    assert pre.metrics["kv_stream_bytes"].value("export") >= 2 * ext["bytes"]
    # the reference client fetches and decodes the port's blob too
    jp = jclient.fetch_kv_blocks(url(pre), fps[-1])
    assert np.array_equal(jp.pages_k, payload.pages_k.numpy())


@pytest.mark.parametrize("q,code", [("fp=424242", 404), ("fp=wat", 400),
                                    ("", 400)])
def test_kv_blocks_miss_and_bad_query(fleet, q, code):
    (pre, _), _ = fleet
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(url(pre) + "/kv/blocks?" + q, timeout=10)
    assert ei.value.code == code


@pytest.mark.parametrize("kw", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_kv_source_hook_imports_and_serves_parity(fleet, params, kw):
    (pre, _), (dec, dec_cont) = fleet
    p = prompt(22 if not kw else 26)
    cold = t_engine(params)
    try:
        expect = cold.generate(p, 5, timeout=120, **kw)
    finally:
        cold.stop()
    post(pre, {"prompt": p, "max_tokens": 0})
    imports = dec_cont.imports_total
    body = {"prompt": p, "max_tokens": 5, "kubeinfer_kv_source": url(pre),
            **kw}
    status, doc = post(dec, body)
    assert status == 200 and doc["choices"][0]["tokens"] == expect
    assert dec_cont.imports_total == imports + 1
    assert dec.metrics["kv_stream_blocks"].value("import") >= len(p) // BS
    # locally warm now: the repeat skips the fetch
    status, doc = post(dec, body)
    assert doc["choices"][0]["tokens"] == expect
    assert dec_cont.imports_total == imports + 1


def test_kv_source_unreachable_falls_back_locally(fleet, params):
    _, (dec, _) = fleet
    p = prompt(23)
    cold = t_engine(params)
    try:
        expect = cold.generate(p, 4, timeout=120)
    finally:
        cold.stop()
    status, doc = post(dec, {"prompt": p, "max_tokens": 4,
                             "kubeinfer_kv_source": "http://127.0.0.1:9"})
    assert status == 200 and doc["kubeinfer"]["route"] == "continuous"
    assert doc["choices"][0]["tokens"] == expect
    assert dec.metrics["disagg_fallbacks"].value("fetch_error") > 0


@pytest.fixture
def stalled():
    """A listener that accepts connections and never answers."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    yield f"http://127.0.0.1:{sock.getsockname()[1]}"
    sock.close()


CLIENT_CASES = ["no_full_block", "fetch_error", "timeout", "wire_error",
                "fingerprint_mismatch", "kv_dtype_mismatch"]


@pytest.mark.parametrize("case", CLIENT_CASES)
def test_client_fallback_labels_equal_reference(fleet, params, ref, stalled,
                                                case):
    """Each client fallback, through the port's client into a port engine
    and through the reference's client into a JAX engine, against the same
    port server: the same label, and nothing imported."""
    (pre, _), _ = fleet
    ours = prompt(24)
    fps = prefix_fingerprints(ours, BS)
    base, tokens, kv = url(pre), ours, "bf16"
    if case == "no_full_block":
        tokens = ours[:BS - 1]
    elif case == "fetch_error":
        base = "http://127.0.0.1:9"
    elif case == "timeout":
        base = stalled
    elif case == "wire_error":
        pre.kv_exports.put(fps[-1], b'{"magic": "nope"}\nxxxx')
    elif case == "fingerprint_mismatch":
        # a stale export: someone else's pages under OUR deepest print
        pre.kv_exports.put(fps[-1], encode(
            twire, ref["bf16"]["port_req"].kv_export))
    else:  # a v1 (bf16) blob offered to int8 importers
        pre.kv_exports.put(fps[-1], _retarget(ref, ours))
        kv = "int8"
    got = []
    for mk, client in ((j_engine, jclient), (t_engine, tclient)):
        eng = mk(params, kv_dtype=kv)
        try:
            n, reason, _ = client.import_remote_prefix(eng, tokens, base,
                                                       timeout_s=0.3)
            got.append((n, reason, eng.imports_total))
        finally:
            eng.stop()
    assert got[1] == got[0] == (0, case, 0)


def _retarget(ref, tokens):
    """A valid v1 blob whose chain matches ``tokens`` (pages of the
    reference export, fingerprints of ours): only its dtype is wrong for
    an int8 importer."""
    exp = ref["bf16"]["port_req"].kv_export
    fps = prefix_fingerprints(tokens, BS)
    return twire.encode_payload(exp["pages_k"], exp["pages_v"], fps, BS)


def test_import_remote_chain_over_v3_chunks(fleet, params, ref):
    (pre, _), _ = fleet
    exp = ref["bf16"]["port_req"].kv_export
    fps = exp["fingerprints"]
    for lo, hi in ((0, 2), (2, 4)):
        blob = twire.encode_payload(
            exp["pages_k"][:, lo:hi], exp["pages_v"][:, lo:hi], fps[lo:hi],
            BS, start_block=lo)
        pre.kv_exports.put(fps[hi - 1], blob)
    eng = t_engine(params)
    try:
        n, reason, nbytes = tclient.import_remote_chain(
            eng, PROMPT, url(pre), chunk_blocks=2)
        assert (n, reason) == (N, None) and nbytes > 0
        assert eng.imports_total == 2
        assert streams(eng) == ref["bf16"]["port_cold"]
        # a chunk served at the wrong offset fails the slice check
        pre.kv_exports.put(fps[3], twire.encode_payload(
            exp["pages_k"][:, 2:4], exp["pages_v"][:, 2:4], fps[2:4], BS,
            start_block=1))
        assert tclient.import_remote_chain(
            eng, PROMPT, url(pre), chunk_blocks=2)[:2] == (
            2, "fingerprint_mismatch")
    finally:
        eng.stop()


@pytest.mark.parametrize("mb,want", [("0", None), ("2", 2 << 20),
                                     ("0.5", 1 << 19)])
def test_kv_export_budget_flag_builds_the_byte_budget(mb, want):
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0", "--batch-slots",
         "2", "--max-model-len", "128", "--kv-export-budget-mb", mb],
        device="cpu")
    try:
        assert srv.kv_exports.max_bytes == want
    finally:
        srv.stop()
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0", "--batch-slots",
         "0", "--max-model-len", "128"], device="cpu")
    try:
        assert cont is None and srv.kv_exports is None
    finally:
        srv.stop()


def test_prefill_only_needs_the_continuous_batcher(fleet):
    (pre, _), _ = fleet
    with pytest.raises(ValueError, match="prefill-only"):
        pre.complete({"prompt": list(range(1, 200)), "max_tokens": 0})
    with pytest.raises(ValueError, match="resume"):
        pre.complete({"prompt": list(range(1, 200)), "max_tokens": 4,
                      "kubeinfer_resume": {"tokens": [3]}})
