"""Sequence, expert and pipeline parallelism on the card (``cuda``-marked;
skips without one). No JAX here: f32 parameters at head width 64, so the
decode kernel (#10) launches on every sp x tp rank's decode and the paged
kernel (#11) in a Mixtral-shaped batcher:

- ``SPEngine`` over sp=2 and sp=2 x tp=2 ranks of ``cuda:0`` against the
  single-device ``Engine``, greedy and sampled, streams equal, every #10
  call held to its plain version (f32 within 1e-5);
- a MoE ``ContinuousEngine`` on the card equal to the same engine on the
  CPU (``device="cpu"``, the plain versions), #11 held on every call;
- ``pipeline_forward`` over pp=2 ranks of ``cuda:0`` and ``moe_block_ep``
  over ep=2 against the dense forms, within 1e-4 (f32).

Run on the card: ``python -m pytest -m cuda tests/test_torch_sp_card.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import flash_attention as fa
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.engine import Engine
from kubeinfer_tpu_torch.inference.moe import (
    make_ep_mesh,
    moe_block,
    moe_block_ep,
)
from kubeinfer_tpu_torch.inference.pipeline import (
    make_pp_mesh,
    pipeline_forward,
)
from kubeinfer_tpu_torch.inference.sharding import (
    make_inference_mesh,
    shard_params,
)
from kubeinfer_tpu_torch.inference.sp_engine import SPEngine

CFG = dataclasses.replace(PRESETS["tiny"], hidden_size=256,
                          intermediate_size=512, num_attention_heads=4,
                          num_key_value_heads=2,
                          max_position_embeddings=1024)
MOE = dataclasses.replace(CFG, num_local_experts=4, num_experts_per_tok=2)


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


class Held:
    """#10 (or #11) held to its plain version on every call, f32 within
    1e-5; counts the calls."""

    def __init__(self, name):
        self.name, self.kernel = name, getattr(fa, name)
        self.plain = getattr(fa, name + "_plain")
        self.calls = 0
        # the launcher counts on, and reads the walk counter of, the name
        # the module holds at call time: this object
        self.launches = 0
        self.walk_counter = None

    def __enter__(self):
        setattr(fa, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(fa, self.name, self.kernel)

    def __call__(self, *args):
        got = self.kernel(*args)
        want = self.plain(*args)
        live = args[-1] > 0
        assert torch.allclose(got[live], want[live], rtol=0, atol=1e-5)
        self.calls += 1
        return got


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2])
def test_sp_engine_on_the_card_equals_the_engine(tp):
    dev = card()
    params = tm.init_params(CFG, seed=2, device=dev)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, n).tolist() for n in (300, 170)]
    mesh = make_inference_mesh(tp=tp, sp=2, dp=1, devices=[dev] * (2 * tp))
    sp = SPEngine(params if tp == 1 else shard_params(params, mesh, CFG),
                  CFG, mesh, min_prompt=64)
    eng = Engine(params, CFG, device=dev)
    for kw in ({}, dict(temperature=0.8, top_p=0.9, seed=3)):
        with Held("decode_attention") as held:
            got = sp.generate(prompts, 12, **kw)
        assert held.calls == 11 * CFG.num_hidden_layers * tp
        want = eng.generate(prompts, 12, **kw)
        assert got.tokens.tolist() == want.tokens.tolist()


@pytest.mark.cuda
def test_moe_batcher_on_the_card_equals_the_cpu():
    dev = card()
    params = tm.init_params(MOE, seed=3, device=dev)
    prompts = [np.random.default_rng(6).integers(1, 256, n).tolist()
               for n in (140, 9)]

    def streams(d, p):
        eng = ContinuousEngine(p, MOE, n_slots=2, cache_len=256,
                               block_size=128, device=d).start()
        try:
            return [eng.generate(x, 10) for x in prompts] + [
                eng.generate(prompts[0], 10, temperature=0.8, top_k=20,
                             seed=4)]
        finally:
            eng.stop()

    with Held("decode_attention_blocks") as held:
        got = streams(dev, params)
    assert held.calls > 0
    assert got == streams("cpu", tm.params_to(params, "cpu"))


@pytest.mark.cuda
def test_pipeline_and_ep_on_the_card_equal_the_dense_forms():
    dev = card()
    cfg = dataclasses.replace(MOE, num_hidden_layers=4)
    params = tm.init_params(cfg, seed=4, device=dev)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, 256, (4, 64))).to(dev)
    dense, _ = tm.forward(params, toks, cfg, attn_fn=tm.attention)
    got = pipeline_forward(params, toks, cfg, make_pp_mesh(2, [dev] * 2), 2)
    assert torch.allclose(got, dense, rtol=1e-4, atol=1e-4)
    moe = params["layers"][0]["moe"]
    x = torch.randn((2, 8, cfg.hidden_size), device=dev)
    assert torch.allclose(moe_block_ep(moe, x, make_ep_mesh(2, [dev] * 2)),
                          moe_block(moe, x), rtol=1e-4, atol=1e-4)
