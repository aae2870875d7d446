"""CLI: ``python -m kubeinfer_tpu_torch.observability`` — one traced request.

Boots a tiny-preset engine + continuous batcher + inference server and a
store server on loopback, issues ONE /v1/completions request (plus a
store round trip) under a single client root span, and writes that
trace as Chrome trace-event JSON — the zero-setup way to see the span
model end-to-end.

A copy of ``kubeinfer_tpu/observability/__main__.py`` for the PyTorch
port, with two differences: ``--device`` (default ``cuda``; without a
card the command exits 1 with "CUDA is not available (--device cuda)")
takes the place of the reference's forced CPU, and the default ``--out``
is ``docs/traces/serving_demo_torch.trace.json``, so the reference's
checked-in artifact is never overwritten.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m kubeinfer_tpu_torch.observability",
        description="run one traced serving request; write a "
                    "Perfetto-loadable Chrome trace JSON")
    ap.add_argument("--out",
                    default="docs/traces/serving_demo_torch.trace.json",
                    help="output path for the trace JSON")
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="where the engine runs: cuda (the default; fails "
                         "without a card) or cpu")
    args = ap.parse_args(argv)

    import urllib.request

    from kubeinfer_tpu_torch.controlplane.httpstore import (
        RemoteStore,
        StoreServer,
    )
    from kubeinfer_tpu_torch.controlplane.store import Store
    from kubeinfer_tpu_torch.device import resolve_device
    from kubeinfer_tpu_torch.inference import PRESETS, init_params
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.server import InferenceServer
    from kubeinfer_tpu_torch.observability import tracing
    from kubeinfer_tpu_torch.utils.httpbase import inject_traceparent

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:  # the device is not there
        print(f"{e} (--device {args.device})", file=sys.stderr)
        return 1
    cfg = PRESETS["tiny"]
    params = init_params(cfg, seed=0, device=dev)
    cont = ContinuousEngine(params, cfg, n_slots=2, cache_len=64,
                            device=dev).start()
    srv = InferenceServer(
        Engine(params, cfg, device=dev), model_id="trace-demo", port=0,
        continuous=cont, device=dev,
    ).start()
    store_srv = StoreServer(Store(), port=0).start()
    remote = RemoteStore(store_srv.address)
    tracer = tracing.get_tracer("client")
    try:
        # warm the engine OUTSIDE the demo trace, so the span durations
        # in the artifact reflect serving, not first-call set-up
        cont.generate([1, 2, 3], max_new_tokens=2)
        tracing.RECORDER.clear()
        with tracer.span("client.request") as root:
            remote.create("Widget", {
                "metadata": {"name": "demo", "namespace": "default"},
            })
            remote.get("Widget", "demo")
            body = json.dumps({
                "prompt": [3, 1, 4, 1, 5], "max_tokens": args.max_tokens,
            }).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=body, method="POST",
                headers=inject_traceparent(
                    {"Content-Type": "application/json"}
                ),
            )
            with urllib.request.urlopen(req, timeout=120) as resp:
                json.loads(resp.read())
        trace_id = root.trace_id
    finally:
        srv.stop()
        store_srv.shutdown()
        cont.stop()

    doc = tracing.RECORDER.to_chrome_trace(trace_id)
    # the server's /debug/spans does this merge live; the artifact
    # carries the same counter tracks so the demo shows the occupancy /
    # queue-depth / kv-block curves next to the spans
    srv._merge_counter_tracks(doc)
    counters = sum(1 for e in doc["traceEvents"] if e.get("ph") == "C")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(doc, indent=1) + "\n")
    spans = tracing.RECORDER.snapshot(trace_id)
    components = sorted({s.component for s in spans})
    print(f"trace {trace_id}: {len(spans)} spans across "
          f"{len(components)} components {components}; "
          f"{counters} counter samples")
    print(f"wrote {out} — open at https://ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    sys.exit(main())
