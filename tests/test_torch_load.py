"""The port's checkpoint path against the JAX package's, on the CPU.

A small llama-family HF checkpoint is written from the reference's
``init_params`` (HF ``[out, in]`` projections, two shards, f32 or bf16
files, with and without the ``model.`` prefix) with the installed
``safetensors``. The port's own reader gives every array bitwise what
``safetensors.safe_open`` gives; the port's ``load_pretrained`` gives
every leaf bitwise the reference's ``load_pretrained`` on the same
directory (weight dtypes bf16 and int8; llama untied, tied embeddings,
qwen2's q/k/v biases); the failures raise. ``save_checkpoint`` then
``restore_checkpoint`` is lossless and writes the reference's
``meta.json``; a training step after a restore is the step on the
original tree. The server loads a directory with ``--model`` (and
``--draft-model``) and answers with the tokens of the reference's
engines on the reference's load of it; with tokenizer files next to
the weights, string prompts and EOS stops answer as the reference
server does.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file

from kubeinfer_tpu.inference import ModelConfig as JCfg
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import weights as jw
from kubeinfer_tpu.inference.checkpoint import save_checkpoint as j_save
from kubeinfer_tpu_torch.inference import checkpoint as tck
from kubeinfer_tpu_torch.inference import server as ts
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import ModelConfig as TCfg

BASE = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512,
            rms_norm_eps=1e-5, rope_theta=10000.0)
FAMILIES = {
    "llama": dict(model_type="llama", tie_word_embeddings=False),
    "tied": dict(model_type="llama", tie_word_embeddings=True),
    "qwen2": dict(model_type="qwen2", tie_word_embeddings=False),
}


def hf_config(family: str) -> dict:
    return {**BASE, **FAMILIES[family]}


def hf_state_dict(tree, cfg, prefix: str) -> dict[str, np.ndarray]:
    """The reference's numpy tree under HF names, projections [out, in]."""
    sd = {f"{prefix}embed_tokens.weight": tree["embed_tokens"],
          f"{prefix}norm.weight": tree["norm"]}
    for i, layer in enumerate(tree["layers"]):
        p = f"{prefix}layers.{i}."
        sd[p + "input_layernorm.weight"] = layer["input_layernorm"]
        sd[p + "post_attention_layernorm.weight"] = \
            layer["post_attention_layernorm"]
        for n in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{n}.weight"] = layer[n].T
        for n in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{n}.weight"] = layer[n].T
        if cfg.qkv_bias:
            for n in ("q", "k", "v"):
                sd[p + f"self_attn.{n}_proj.bias"] = layer[f"{n}_bias"]
    if "lm_head" in tree:
        sd["lm_head.weight"] = tree["lm_head"].T
    return sd


def write_checkpoint(root: pathlib.Path, family: str, file_dtype: str,
                     prefix: str, seed: int = 0) -> pathlib.Path:
    """config.json + two shards of the reference's init_params."""
    root.mkdir(parents=True, exist_ok=True)
    d = hf_config(family)
    (root / "config.json").write_text(json.dumps(d))
    cfg = JCfg.from_hf_dict(d)
    tree = jax.tree.map(np.asarray, j_init(cfg, jax.random.PRNGKey(seed)))
    sd = hf_state_dict(tree, cfg, prefix)
    cast = (lambda a: a.astype(ml_dtypes.bfloat16)) if file_dtype == "bf16" \
        else (lambda a: np.ascontiguousarray(a, np.float32))
    sd = {k: np.ascontiguousarray(cast(v)) for k, v in sd.items()}
    names = sorted(sd)
    half = len(names) // 2
    for i, part in enumerate((names[:half], names[half:])):
        save_file({k: sd[k] for k in part},
                  str(root / f"model-0000{i + 1}-of-00002.safetensors"))
    return root


@pytest.fixture(autouse=True)
def offline(monkeypatch):
    """Every tokenizer lookup here is of a local directory."""
    monkeypatch.setenv("HF_HUB_OFFLINE", "1")


CASES = [("llama", "bf16", "model."), ("tied", "f32", ""),
         ("qwen2", "bf16", ""), ("llama", "f32", "model.")]
CASE_IDS = ["-".join((f, d, p.rstrip(".") or "bare")) for f, d, p in CASES]


@pytest.fixture(scope="module", params=CASES, ids=CASE_IDS)
def ckpt(request, tmp_path_factory):
    family, dt, prefix = request.param
    root = tmp_path_factory.mktemp("ckpt") / "-".join(request.param)
    return write_checkpoint(root, family, dt, prefix)


def bits(a) -> np.ndarray:
    """Raw bits of a numpy / jax / torch array, bf16 as int16."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}" if prefix else k)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}.{i}")
    else:
        yield prefix, tree


def assert_trees_bitwise(got, want):
    g, w = dict(leaves(got)), dict(leaves(want))
    assert sorted(g) == sorted(w)
    for name in w:
        gb, wb = bits(g[name]), bits(w[name])
        assert gb.dtype == wb.dtype and gb.shape == wb.shape, name
        np.testing.assert_array_equal(gb, wb, err_msg=name)


def test_reader_matches_safe_open(ckpt):
    for shard in sorted(ckpt.glob("*.safetensors")):
        ours = tw.read_safetensors(shard)
        with safe_open(str(shard), framework="np") as f:
            assert sorted(ours) == sorted(f.keys())
            for name in f.keys():
                want = f.get_tensor(name)
                got = bits(ours[name])
                assert got.shape == want.shape
                np.testing.assert_array_equal(got, bits(want), err_msg=name)


@pytest.mark.parametrize("weight_dtype", ["bf16", "int8"])
def test_load_pretrained_matches_reference(ckpt, weight_dtype):
    got, cfg = tw.load_pretrained(str(ckpt), weight_dtype=weight_dtype,
                                  device="cpu")
    want, jcfg = jw.load_pretrained(str(ckpt), dtype=jnp.bfloat16,
                                    weight_dtype=weight_dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert_trees_bitwise(got, want)


def test_load_pretrained_f32(ckpt):
    got, _ = tw.load_pretrained(str(ckpt), dtype=torch.float32, device="cpu")
    want, _ = jw.load_pretrained(str(ckpt), dtype=jnp.float32)
    assert_trees_bitwise(got, want)


def test_mixtral_raises_naming_entry_12(tmp_path):
    """A Mixtral checkpoint is read with its expert naming (parity:
    ``tests/test_torch_moe.py``); one whose expert tensor is missing
    raises the reference's ``KeyError`` naming it."""
    d = {**hf_config("llama"), "model_type": "mixtral",
         "num_local_experts": 4}
    (tmp_path / "config.json").write_text(json.dumps(d))
    cfg = JCfg.from_hf_dict(d)
    tree = jax.tree.map(np.asarray, j_init(
        dataclasses.replace(cfg, num_local_experts=0), jax.random.PRNGKey(0)))
    # the dense MLP's names where the experts' belong
    save_file({k: np.ascontiguousarray(v, np.float32) for k, v in
               hf_state_dict(tree, cfg, "model.").items()},
              str(tmp_path / "model.safetensors"))
    want = "block_sparse_moe.gate.weight"
    with pytest.raises(KeyError, match=want):
        jw.load_pretrained(str(tmp_path), dtype=jnp.float32)
    with pytest.raises(KeyError, match=want):
        tw.load_pretrained(str(tmp_path), device="cpu")


def test_missing_shards_raise(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps(hf_config("llama")))
    with pytest.raises(FileNotFoundError,
                       match=r"no \*\.safetensors under"):
        tw.load_pretrained(str(tmp_path), device="cpu")
    with pytest.raises(FileNotFoundError):
        tw.load_pretrained(str(tmp_path / "absent"), device="cpu")


def test_truncated_and_malformed_shards_raise(tmp_path):
    path = tmp_path / "x.safetensors"
    tw.write_safetensors(path, {"a": torch.arange(64, dtype=torch.float32)})
    raw = path.read_bytes()
    path.write_bytes(raw[:-4])  # the buffer ends short
    with pytest.raises(ValueError, match="past the end"):
        tw.read_safetensors(path)
    path.write_bytes(raw[:6])  # not even the header length
    with pytest.raises(ValueError):
        tw.read_safetensors(path)

    def with_header(header: dict, body: bytes) -> None:
        h = json.dumps(header).encode()
        path.write_bytes(len(h).to_bytes(8, "little") + h + body)

    with_header({"a": {"dtype": "Q4", "shape": [4],
                       "data_offsets": [0, 2]}}, b"\0\0")
    with pytest.raises(ValueError, match="unknown dtype 'Q4'"):
        tw.read_safetensors(path)
    with_header({"a": {"dtype": "F32", "shape": [4],
                       "data_offsets": [0, 12]}}, b"\0" * 16)
    with pytest.raises(ValueError, match="16 expected"):
        tw.read_safetensors(path)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, "int8"],
                         ids=["f32", "bf16", "int8"])
def test_writer_roundtrip_through_safe_open(tmp_path, dtype):
    """The port's writer gives files the safetensors package reads."""
    t = torch.randn(5, 7, generator=torch.Generator().manual_seed(0))
    t = t.to(torch.int8) if dtype == "int8" else t.to(dtype)
    tw.write_safetensors(tmp_path / "w.safetensors", {"t": t, "e": t[:0]})
    with safe_open(str(tmp_path / "w.safetensors"), framework="np") as f:
        np.testing.assert_array_equal(bits(f.get_tensor("t")), bits(t))
        assert f.get_tensor("e").shape == (0, 7)


# -- checkpoint.py ----------------------------------------------------------

def reference_tree(weight_dtype: str, dtype):
    from kubeinfer_tpu.inference import PRESETS

    cfg = PRESETS["tiny"]
    p = j_init(cfg, jax.random.PRNGKey(4), dtype=dtype,
               weight_dtype=weight_dtype)
    return p, cfg


TREES = [("bf16", jnp.float32), ("bf16", jnp.bfloat16),
         ("int8", jnp.bfloat16)]


@pytest.mark.parametrize("weight_dtype,dtype", TREES,
                         ids=["f32", "bf16", "int8"])
def test_save_restore_lossless_and_meta_matches(tmp_path, weight_dtype,
                                                dtype):
    jp, cfg = reference_tree(weight_dtype, dtype)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    params = tw.params_from_reference(jax.tree.map(np.asarray, jp), "cpu",
                                      tdt)
    tcfg = TCfg(**dataclasses.asdict(cfg))
    tck.save_checkpoint(str(tmp_path / "ck"), params, tcfg, step=17)
    got, rcfg, step = tck.restore_checkpoint(str(tmp_path / "ck"),
                                             device="cpu")
    assert step == 17 and rcfg == tcfg
    assert_trees_bitwise(got, params)
    assert_trees_bitwise(got, jp)
    j_save(str(tmp_path / "ref"), jp, cfg, step=17)
    assert json.loads((tmp_path / "ck" / "meta.json").read_text()) == \
        json.loads((tmp_path / "ref" / "meta.json").read_text())
    # atomic on completion: nothing but the checkpoint is left beside it
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ck", "ref"]
    with pytest.raises(FileExistsError):
        tck.save_checkpoint(str(tmp_path / "ck"), params, tcfg)


def test_restore_refusals(tmp_path):
    """A missing checkpoint raises; a sharded restore (``mesh=``) gives
    each tp rank its shard of the saved tree, and a mesh whose tp does
    not divide a sharded dim raises."""
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.sharding import (
        make_inference_mesh,
        unshard_params,
    )

    with pytest.raises(FileNotFoundError):
        tck.restore_checkpoint(str(tmp_path / "nope"), device="cpu")
    cfg = TCfg(**dataclasses.asdict(reference_tree("bf16", jnp.float32)[1]))
    params = init_params(cfg, seed=3, device="cpu")
    tck.save_checkpoint(str(tmp_path / "ck"), params, cfg, step=5)
    mesh = make_inference_mesh(tp=2, devices=["cpu"] * 2)
    got, gcfg, step = tck.restore_checkpoint(str(tmp_path / "ck"),
                                             mesh=mesh)
    assert (gcfg, step, got.tp) == (cfg, 5, 2)
    q = params["layers"][0]["q_proj"]
    w = q.shape[1] // 2
    assert torch.equal(got.shards[1]["layers"][0]["q_proj"], q[:, w:])
    assert got.shards[1]["layers"][0]["q_proj"].is_contiguous()
    full = unshard_params(got)
    for name in ("embed_tokens", "norm"):
        assert torch.equal(full[name], params[name])
    assert torch.equal(full["layers"][1]["down_proj"],
                       params["layers"][1]["down_proj"])
    with pytest.raises(ValueError, match="divide"):
        tck.restore_checkpoint(str(tmp_path / "ck"), mesh=make_inference_mesh(
            tp=3, devices=["cpu"] * 3))


def test_train_step_after_restore(tmp_path):
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.train import train_step

    cfg = TCfg(**dataclasses.asdict(reference_tree("bf16", jnp.float32)[1]))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 12)))
    params, _ = train_step(init_params(cfg, seed=2, device="cpu"), toks, cfg)
    tck.save_checkpoint(str(tmp_path / "ck"), params, cfg, step=1)
    restored, _, _ = tck.restore_checkpoint(str(tmp_path / "ck"),
                                            device="cpu")
    restored, loss_a = train_step(restored, toks, cfg)
    params, loss_b = train_step(params, toks, cfg)
    assert float(loss_a) == float(loss_b)
    assert_trees_bitwise(restored, params)


# -- the server's load path ---------------------------------------------------

@pytest.fixture(scope="module")
def llama_dir(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("srv") / "m", "llama",
                            "f32", "model.", seed=5)


def reference_engines(model_dir, weight_dtype="bf16", draft=False):
    """The reference's engines as its server builds them for the flags
    ``--dtype float32 --batch-slots 2 --max-model-len 128``."""
    from kubeinfer_tpu.inference.batching import ContinuousEngine
    from kubeinfer_tpu.inference.engine import Engine
    from kubeinfer_tpu.inference.speculative import SpeculativeEngine

    params, cfg = jw.load_pretrained(model_dir, dtype=jnp.float32,
                                     weight_dtype=weight_dtype)
    spec = spec_draft = None
    if draft:
        dparams, dcfg = jw.load_pretrained(model_dir, dtype=jnp.float32)
        spec = SpeculativeEngine(params, cfg, dparams, dcfg, k=4,
                                 max_cache_len=128)
        spec_draft = (dparams, dcfg)
    cont = ContinuousEngine(params, cfg, n_slots=2, cache_len=128,
                            speculative=spec, prefill_chunk_blocks=4,
                            spec_draft=spec_draft, spec_k=4,
                            weight_dtype=weight_dtype).start()
    return Engine(params, cfg, max_cache_len=128), cont


SERVE = ["--port", "0", "--batch-slots", "2", "--max-model-len", "128",
         "--dtype", "float32", "--device", "cpu"]
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
SAMPLED = dict(temperature=0.7, top_k=5, seed=4)


@pytest.mark.parametrize("flags", [[], ["--weight-dtype", "int8"],
                                   ["--draft-model", "DIR",
                                    "--speculative-draft"],
                                   ["--batch-slots", "0"]],
                         ids=["bf16", "int8", "draft", "engine"])
def test_server_serves_the_checkpoint(llama_dir, flags):
    flags = [str(llama_dir) if f == "DIR" else f for f in flags]
    srv, cont = ts.build_server(["--model", str(llama_dir), *SERVE, *flags])
    wdt = "int8" if "int8" in flags else "bf16"
    want, _ = tw.load_pretrained(str(llama_dir), torch.float32, wdt, "cpu")
    assert_trees_bitwise(srv.engine.params, want)
    if "--draft-model" in flags:
        assert_trees_bitwise(srv.speculative.draft_params,
                             tw.load_pretrained(str(llama_dir),
                                                torch.float32,
                                                device="cpu")[0])
        assert cont.spec_draft is not None
    if cont is not None:
        cont.start()
    jeng, jcont = reference_engines(str(llama_dir), wdt,
                                    "--draft-model" in flags)
    try:
        for kw in ({}, SAMPLED):
            got = srv.complete(dict(prompt=PROMPT, max_tokens=8, **kw))
            assert got["choices"][0]["finish_reason"] == "length"
            toks = got["choices"][0]["tokens"]
            if cont is None:
                assert got["kubeinfer"]["route"] == "engine"
                out = jeng.generate([PROMPT], 8, **kw)
                assert toks == np.asarray(out.tokens[0]).tolist()
            else:
                assert got["kubeinfer"]["route"] == "continuous"
                assert toks == jcont.generate(PROMPT, 8, **kw)
    finally:
        jcont.stop()
        if cont is not None:
            cont.stop()
        srv.stop()


def write_tokenizer(root: pathlib.Path, vocab: int, eos: int) -> None:
    """A word-level tokenizer over ``w0 .. w{vocab-1}`` (id i = ``wi``)
    with ``w{eos}`` its EOS, as files next to the weights."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    tok = Tokenizer(models.WordLevel(
        {f"w{i}": i for i in range(vocab)}, unk_token="w0"))
    tok.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tok.save(str(root / "tokenizer.json"))
    (root / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast",
        "eos_token": f"w{eos}", "unk_token": "w0"}))


def test_tokenizer_string_prompts_and_eos_stop(llama_dir, tmp_path,
                                               monkeypatch):
    import shutil

    from kubeinfer_tpu.inference import server as js

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    d = tmp_path / "tok"
    shutil.copytree(llama_dir, d)
    # EOS is the fourth greedy token of the prompt, so the stream stops
    jeng, jcont = reference_engines(str(d))
    try:
        eos = jcont.generate(PROMPT, 8)[3]
        write_tokenizer(d, 256, eos)
        srv, cont = ts.build_server(["--model", str(d), *SERVE])
        cont.start()
        assert srv.tokenizer is not None
        ref = js.InferenceServer(jeng, str(d), tokenizer=js._load_tokenizer(
            str(d)), continuous=jcont, port=0)
        text = " ".join(f"w{i}" for i in PROMPT)
        for kw in ({}, SAMPLED):
            body = dict(prompt=text, max_tokens=8, **kw)
            got, want = srv.complete(body), ref.complete(body)
            assert got["choices"] == want["choices"]
            assert got["usage"] == want["usage"]
        greedy = srv.complete(dict(prompt=text, max_tokens=8))["choices"][0]
        assert greedy["finish_reason"] == "stop"
        assert greedy["tokens"][-1] == eos and len(greedy["tokens"]) <= 4
        ref.stop()
        cont.stop()
        srv.stop()
    finally:
        jcont.stop()


def test_no_tokenizer_runs_id_only_with_the_reference_warning(
        llama_dir, caplog, monkeypatch):
    from kubeinfer_tpu.inference import server as js

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    with caplog.at_level(logging.WARNING):
        srv, cont = ts.build_server(["--model", str(llama_dir), *SERVE,
                                     "--batch-slots", "0"])
        assert js._load_tokenizer(str(llama_dir)) is None
    try:
        assert srv.tokenizer is None
        ours, theirs = [[r.getMessage() for r in caplog.records
                         if r.name == name and "no tokenizer" in
                         r.getMessage()]
                        for name in (ts.log.name, js.log.name)]
        assert len(ours) == 1 and ours == theirs
        assert "id-only mode" in ours[0]
        with pytest.raises(ValueError, match="tokenizer"):
            srv.complete(dict(prompt="w1 w2"))
    finally:
        srv.stop()
