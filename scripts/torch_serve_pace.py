#!/usr/bin/env python3
"""Serving pace of the PyTorch port's continuous batcher on one card.

    PYTHONPATH=. python3 scripts/torch_serve_pace.py [server flags ...]

Builds the llama-3-8b preset (random weights, seed 0, 8 slots) through
``kubeinfer_tpu_torch.inference.server.build_server`` with the given
flags appended, then measures what chip_smoke.py's phase [16] measures:
the TTFT of a 512-token prompt on the continuous route (5 alone), and
the decode ms per token per slot at 8 live slots (8 prompts of 512, 64
new, the gaps between token times once every row has its first token),
three times. Prints one JSON line with every sample, the card's name and
power limit. Card only.

To compare two trees on the same card, run it from the root of each in
one call (parent, change, change, parent), with ``PYTHONPATH=.`` so the
tree in the working directory is the one imported."""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading

import numpy as np


def main(flags: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_serve_pace: no CUDA device is available",
              file=sys.stderr)
        return 2
    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.inference import server

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[:1]
    _build.build_all(["decode_split", "flash_prefill", "flash_prefill_tc",
                      "quant_matmul", "quant_matmul_tc"])
    srv, cont = server.build_server(
        ["--model", "llama-3-8b", "--random-init", "--port", "0",
         "--host", "127.0.0.1", "--batch-slots", "8", *flags])
    cont.start()
    rng = np.random.default_rng(16)
    V = cont.cfg.vocab_size
    try:
        # the first admits and windows build the kernels' libraries and
        # grow the allocator: not timed
        warm = [rng.integers(1, V, 512).tolist() for _ in range(8)]
        threads = [threading.Thread(target=cont.serve, args=(p, 8))
                   for p in warm]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        ttft = []
        for _ in range(5):
            req = cont.serve(rng.integers(1, V, 512).tolist(), 1)
            ttft.append((req.t_first - req.t_submit) * 1e3)
        decode = []
        for _ in range(3):
            reqs = [None] * 8
            prompts = [rng.integers(1, V, 512).tolist() for _ in range(8)]

            def run(i):
                reqs[i] = cont.serve(prompts[i], 64)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            t_all = max(r.t_first for r in reqs)
            gaps = []
            for r in reqs:
                times = [x for x in r.token_times if x > t_all]
                gaps += list(np.diff(times) * 1e3)
            decode.append(statistics.median(gaps))
    finally:
        cont.stop()
    print(json.dumps({
        "card": card[0] if card else "", "flags": flags,
        "ttft_ms": ttft, "ttft_p50_ms": statistics.median(ttft),
        "decode_ms_per_token": decode,
        "decode_p50_ms": statistics.median(decode),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
