"""Disaggregated prefill/decode of the port on the card, at ``tiny`` size
with blocks of 16 (the gather + dense decode route; the full-width path
and its kernels are ``chip_smoke.py``'s phase 30): a prefill-only export
on one engine, wire-encoded and decoded, imported into another. No JAX
here: the comparison is the port against itself on the same card.

    python -m pytest tests/test_torch_disagg_card.py -m cuda -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.disagg import wire
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.model import init_params

BS = 16
CFG = PRESETS["tiny"]
PROMPT = np.random.default_rng(11).integers(0, 256, 70).tolist()  # 4 blocks
N = len(PROMPT) // BS


def streams(eng):
    return (eng.generate(PROMPT, 6, timeout=120),
            eng.generate(PROMPT, 6, timeout=120, temperature=0.8, seed=123))


def pool_blocks(eng):
    blocks = eng._radix.match(PROMPT[:N * BS])
    eng._pool.unref(blocks)
    return torch.tensor(blocks, device=eng.device)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_export_import_on_card(kv):
    """The landed pages are bitwise the exporter's, and the streams those
    of a third engine warmed by a local prefill-only request (the same
    code on the same card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    dev = torch.device("cuda")
    params = init_params(CFG, seed=3, device=dev)

    def engine():
        return ContinuousEngine(params, CFG, n_slots=2, cache_len=128,
                                block_size=BS, kv_dtype=kv,
                                device=dev).start()

    warm = engine()
    try:
        warm.serve(PROMPT, 0, timeout=120)
        want = streams(warm)
    finally:
        warm.stop()
    a, b = engine(), engine()
    try:
        exp = a.serve(PROMPT, 0, export_kv=True, timeout=120).kv_export
        assert exp["pages_k"].device.type == "cpu"
        p = wire.decode_payload(wire.encode_payload(
            exp["pages_k"], exp["pages_v"], exp["fingerprints"], BS,
            scales_k=exp.get("scales_k"), scales_v=exp.get("scales_v"),
            kv_dtype=kv))
        assert b.import_prefix(
            PROMPT[:N * BS], p.pages_k, p.pages_v, scales_k=p.scales_k,
            scales_v=p.scales_v, kv_dtype=kv) == (N, None)
        ia, ib = pool_blocks(a), pool_blocks(b)
        for pa, pb in zip(a._state.caches_k + a._state.caches_v,
                          b._state.caches_k + b._state.caches_v):
            assert torch.equal(pa[ia], pb[ib])
        if kv == "int8":
            assert torch.equal(a._state.q8_scales[:, :, ia],
                               b._state.q8_scales[:, :, ib])
        assert streams(b) == want
    finally:
        a.stop()
        b.stop()
