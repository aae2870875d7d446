"""The instrumented server on the card at tiny size (no JAX here: the
CPU file ``test_torch_observability.py`` holds the port to the reference;
the full-width path is chip_smoke.py's phase 32). Skips without a card."""

from __future__ import annotations

import json
import urllib.request

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import server as ts


def scrape(port: int) -> dict:
    """{"name{labels}": value} of every sample line of ``/metrics``."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        text = r.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_scrape_matches_the_engine_on_card(kv):
    """Every decode window is recorded once, the step histogram counts
    each record once, and the scrape's token counters equal the answers."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    srv, cont = ts.build_server(
        ["--model", "tiny", "--random-init", "--port", "0", "--batch-slots",
         "2", "--max-model-len", "128", "--kv-dtype", kv,
         "--slo", "ttft:2.0:0.99"])
    cont.start()
    srv.start()
    rng = np.random.default_rng(0)
    try:
        for _ in range(3):
            body = json.dumps({"prompt": rng.integers(0, 256, 20).tolist(),
                               "max_tokens": 9}).encode()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.port}/v1/completions",
                    data=body, timeout=120) as r:
                assert r.status == 200
        m = scrape(srv.port)
        recs = cont.profiler.snapshot()
    finally:
        srv.stop()
        cont.stop()
    decode = [r for r in recs if r.phase == "decode"]
    # the admit samples the first token, the windows the other 8
    assert sum(r.live_tokens for r in decode) == 3 * 8
    hist = "kubeinfer_engine_step_duration_seconds_count"
    steps = sum(v for k, v in m.items() if k.startswith(hist))
    assert steps == len(recs)
    assert m["kubeinfer_inference_completion_tokens_total"] == 27
    assert m['kubeinfer_inference_requests_total{route="continuous",'
             'outcome="ok"}'] == 3
