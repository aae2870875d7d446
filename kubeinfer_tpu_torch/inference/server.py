"""OpenAI-style completions server over the port's engines.

Counterpart of ``kubeinfer_tpu/inference/server.py`` for the serving
path (bf16, or int8 with ``--kv-dtype int8`` and ``--weight-dtype
int8``): ``GET /health``, ``GET /v1/models`` and ``POST
/v1/completions``. A request that fits the continuous batcher's slot
width rides its shared slots (route "continuous"); a longer one, or any
request when ``--batch-slots 0``, goes to the per-request engine (route
"engine"). With ``--draft-model`` a ``SpeculativeEngine`` serves
draft-eligible requests (no repetition penalty, fitting its cache with
the k + 1 slack) that the batcher does not own (route "speculative");
the batcher owns them through its draft groups, or, with
``--speculative-draft``, runs the draft inside its paged batch (verify
windows). Prompts are token ids (no tokenizer). Routes whose engines
wait answer 400 with the reason.

Disaggregated prefill and decode, as in the reference: a request with
``max_tokens=0`` (the prefill replica's role) prefills through the
continuous batcher's admit, and its committed full-block pages wait in
an export cache as one wire blob (``disagg.wire``), served by ``GET
/kv/blocks?fp=<deepest prefix fingerprint>``. A request annotated with
``kubeinfer_kv_source`` (the decode replica's role) first pulls that
blob from the named replica, verifies it and stages the pages into its
pool, then admits warm; every failure falls back to a local prefill and
counts its reason (``disagg_fallbacks``).

    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --kv-dtype int8 --weight-dtype int8
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --draft-model llama-3-8b --speculative-draft --speculation-depth 4
    # two replicas: POST {"prompt": [...], "max_tokens": 0} to :8001, then
    # the same prompt with "kubeinfer_kv_source": "http://127.0.0.1:8001"
    # (and max_tokens > 0) to :8002
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init --port 8001
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init --port 8002

``main(argv, device="cpu")`` runs the same server on the CPU (a
rehearsal with ``--model tiny``).
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from kubeinfer_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

_WAITING_BODY = {
    "kubeinfer_resume": "live-session resume waits: ROADMAP Queue 1, "
                        "preemption, drain and migration",
}


class InferenceServer:
    def __init__(self, engine, model_id: str, host: str = "127.0.0.1",
                 port: int = 8000, continuous=None, speculative=None,
                 device=None, kv_export_budget_mb: float = 0.0) -> None:
        self.device = resolve_device(device)
        for e in (engine, continuous, speculative):
            if e is not None and e.device != self.device:
                raise ValueError(f"engine on {e.device}, server on "
                                 f"{self.device}")
        self.engine = engine
        self.continuous = continuous  # ContinuousEngine | None
        self.speculative = speculative  # SpeculativeEngine | None
        self.model_id = model_id
        # disaggregated-prefill export staging: prefill-only completions
        # park their wire-encoded KV here, keyed by the deepest prefix
        # fingerprint, until a decode replica pulls it from /kv/blocks.
        # Only with a continuous engine (its paged pool is what exports);
        # --kv-export-budget-mb bounds it in bytes too (0 = entries only)
        self.kv_exports = None
        if continuous is not None:
            from kubeinfer_tpu_torch.disagg.export import KVExportCache

            self.kv_exports = KVExportCache(
                max_bytes=(int(kv_export_budget_mb * (1 << 20))
                           if kv_export_budget_mb > 0 else None))
        # the transfer plane seen from both ends, per direction ("export":
        # blobs served at /kv/blocks; "import": prefixes landed through
        # import_prefix): blocks, wire bytes, and the seconds of the
        # latest operations (export: serving the blob; import: fetch +
        # verify + staged write); fallbacks to local prefill by reason.
        # The export cache's evictions are ``kv_exports.stats()
        # ["evictions"]``.
        self.kv_stream_blocks: collections.Counter = collections.Counter()
        self.kv_stream_bytes: collections.Counter = collections.Counter()
        self.kv_stream_seconds = {
            d: collections.deque(maxlen=1024) for d in ("export", "import")}
        self.disagg_fallbacks: collections.Counter = collections.Counter()
        self._kv_lock = threading.Lock()
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # no per-request stderr
                return

            def respond(self, code: int, ctype: str, body) -> None:
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path == "/health":
                    self.respond(200, "text/plain", "OK")
                elif path == "/v1/models":
                    self.respond(200, "application/json", json.dumps({
                        "object": "list",
                        "data": [{"id": server.model_id, "object": "model",
                                  "owned_by": "kubeinfer-tpu"}],
                    }))
                elif path == "/kv/blocks":
                    self.kv_blocks()
                else:
                    self.respond(404, "text/plain", "not found\n")

            def kv_blocks(self):
                """One exported prefix by content address (its deepest
                rolling fingerprint); self-verifying on the wire."""
                q = parse_qs(urlparse(self.path).query)
                try:
                    fp = int((q.get("fp") or [""])[0])
                except ValueError:
                    self.respond(400, "application/json", json.dumps(
                        {"error": "fp must be an integer fingerprint"}))
                    return
                blob = (server.kv_exports.get(fp)
                        if server.kv_exports is not None else None)
                if blob is None:
                    # evicted from the export LRU (or never made): the
                    # importer falls back to local prefill
                    self.respond(404, "application/json", json.dumps(
                        {"error": "no export for fingerprint"}))
                    return
                try:
                    hdr = json.loads(blob[:blob.find(b"\n")])
                    nblocks = int(hdr.get("blocks", 0))
                except ValueError:
                    nblocks = 0
                # counted BEFORE the write: the importer's next request
                # may read the counts
                server._count_stream("export", nblocks, len(blob))
                t0 = time.perf_counter()
                self.respond(200, "application/octet-stream", blob)
                with server._kv_lock:
                    server.kv_stream_seconds["export"].append(
                        time.perf_counter() - t0)

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if path != "/v1/completions":
                    self.respond(404, "text/plain", "not found\n")
                    return
                try:
                    resp = server.complete(json.loads(raw or b"{}"))
                    self.respond(200, "application/json", json.dumps(resp))
                except ValueError as e:
                    self.respond(400, "application/json", json.dumps(
                        {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}))
                except Exception as e:  # keep the serving thread alive
                    log.exception("completion failed")
                    self.respond(500, "application/json", json.dumps(
                        {"error": {"message": str(e),
                                   "type": "server_error"}}))

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- request handling --------------------------------------------------

    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, list):
            if not all(isinstance(t, int) for t in prompt):
                raise ValueError("prompt list must contain token ids (ints)")
            return prompt
        if isinstance(prompt, str):
            raise ValueError(
                "string prompts require tokenizer files next to the model "
                "weights; this server was started without them — send "
                "token ids instead")
        raise ValueError("prompt must be a string or a list of token ids")

    def _decode(self, ids: list[int]) -> str:
        return " ".join(str(i) for i in ids)

    def complete(self, body: dict) -> dict:
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        t0 = time.perf_counter()
        route, gen, req, more = self._complete(body)
        ext = {"route": route,
               "latency_ms": (time.perf_counter() - t0) * 1e3, **more}
        if req is not None:
            ext["ttft_ms"] = (req.t_first - req.t_submit) * 1e3
            if self.continuous.spec_draft is not None:
                # the verify route's per-request accounting (the
                # reference records it on its engine.decode span)
                ext["spec_accepted"] = req.spec_accepted
                ext["spec_rollbacks"] = req.spec_rollbacks
        ids_len = len(body["prompt"])
        return {
            "id": "cmpl-kubeinfer" if req is None
            else f"cmpl-kubeinfer-{req.rid}",
            "object": "text_completion",
            "model": self.model_id,
            "choices": [{
                "index": 0,
                "text": self._decode(gen),
                "tokens": gen,
                # no tokenizer, so no EOS: every completion runs to length
                "finish_reason": "length",
            }],
            "usage": {
                "prompt_tokens": ids_len,
                "completion_tokens": len(gen),
                "total_tokens": ids_len + len(gen),
            },
            "kubeinfer": ext,
        }

    def _complete(self, body: dict):
        prompt = body.get("prompt")
        if prompt is None:
            raise ValueError("'prompt' is required")
        ids = self._encode(prompt)
        max_tokens = int(body.get("max_tokens", 16))
        if not (0 <= max_tokens <= 4096):
            raise ValueError(
                "max_tokens must be in [0, 4096] (0 = prefill-only)")
        temperature = float(body.get("temperature", 0.0))
        top_k = int(body.get("top_k", 0))
        top_p = float(body.get("top_p", 1.0))
        rep_penalty = float(body.get("repetition_penalty", 1.0))
        if top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not (0.0 < top_p <= 1.0):
            raise ValueError("top_p must be in (0, 1]")
        if rep_penalty <= 0.0:
            raise ValueError("repetition_penalty must be > 0")
        seed = int(body.get("seed", 0))
        eos_id = -1
        for key, reason in _WAITING_BODY.items():
            if body.get(key) is not None:
                raise ValueError(reason)
        kw = dict(eos_id=eos_id, temperature=temperature, seed=seed,
                  top_k=top_k, top_p=top_p, repetition_penalty=rep_penalty)
        # the decode side: pull the prefill replica's KV into the local
        # pool BEFORE routing, so the continuous admit below finds it warm
        # (this HTTP thread holds no engine lock; the write is staged to
        # the scheduler thread)
        kv_source = body.get("kubeinfer_kv_source")
        if (isinstance(kv_source, str) and kv_source and max_tokens > 0
                and self.continuous is not None
                and self.continuous.fits(len(ids), max_tokens)):
            self._maybe_import_prefix(ids, kv_source)
        if max_tokens == 0:
            return self._prefill_only(ids, kw)
        if (self.speculative is not None and rep_penalty == 1.0
                and self.speculative.fits(len(ids), max_tokens)
                # a batcher with a speculative engine owns the draft-
                # eligible traffic it fits (its groups, or verify windows)
                and not (self.continuous is not None
                         and self.continuous.speculative is not None
                         and self.continuous.fits(len(ids), max_tokens))):
            kw.pop("repetition_penalty")
            out = self.speculative.generate([ids], max_new_tokens=max_tokens,
                                            **kw)
            return "speculative", out.tokens[0, : out.lengths[0]].tolist(), \
                None, {}
        if self.continuous is not None and self.continuous.fits(
                len(ids), max_tokens):
            req = self.continuous.serve(ids, max_new_tokens=max_tokens, **kw)
            return "continuous", list(req.out_tokens), req, {}
        out = self.engine.generate([ids], max_new_tokens=max_tokens, **kw)
        return "engine", out.tokens[0, : out.lengths[0]].tolist(), None, {}

    def _prefill_only(self, ids: list[int], kw: dict):
        """``max_tokens=0``, the prefill replica's role, outranking every
        other route (only the paged pool exports): the prompt runs through
        the continuous batcher's ordinary admit, and its committed pages
        are wire-encoded into the export cache."""
        if not (self.continuous is not None
                and self.continuous.fits(len(ids), 0)):
            raise ValueError(
                "max_tokens=0 (prefill-only) requires the continuous "
                "batcher and a prompt that fits its cache")
        from kubeinfer_tpu_torch.disagg.wire import WireError, encode_payload

        req = self.continuous.serve(ids, max_new_tokens=0, export_kv=True,
                                    **kw)
        more = {}
        exp = req.kv_export
        if exp is not None and self.kv_exports is not None:
            try:
                blob = encode_payload(
                    exp["pages_k"], exp["pages_v"], exp["fingerprints"],
                    exp["block_size"], scales_k=exp.get("scales_k"),
                    scales_v=exp.get("scales_v"),
                    kv_dtype=exp.get("kv_dtype", "bf16"))
            except WireError:
                # the importer falls back to a local prefill: latency,
                # not correctness
                log.exception("kv export encode failed; skipping")
            else:
                fp = exp["fingerprints"][-1]
                self.kv_exports.put(fp, blob)
                more = {"kv_export": {"fingerprint": int(fp),
                                      "blocks": len(exp["fingerprints"]),
                                      "bytes": len(blob)}}
        return "prefill", [], req, more

    def _count_stream(self, direction: str, blocks: int, nbytes: int,
                      seconds: float | None = None) -> None:
        with self._kv_lock:
            self.kv_stream_blocks[direction] += blocks
            self.kv_stream_bytes[direction] += nbytes
            if seconds is not None:
                self.kv_stream_seconds[direction].append(seconds)

    def _maybe_import_prefix(self, ids: list[int], base_url: str) -> None:
        """Pull this prompt's exported KV prefix from ``base_url`` into
        the local pool + radix cache. Best-effort: every failure counts a
        fallback reason and the request prefills locally (token-
        identical). A prompt whose deepest fingerprint the engine already
        advertises (an earlier import or admit) is not fetched again."""
        from kubeinfer_tpu_torch.disagg.client import import_remote_prefix
        from kubeinfer_tpu_torch.inference.kv_blocks import (
            prefix_fingerprints,
        )

        eng = self.continuous
        fps = prefix_fingerprints(ids, eng.block_size)
        if not fps:
            return  # sub-block prompt: nothing a prefill replica can ship
        if fps[-1] in set(eng.cache_summary().get("fingerprints", [])):
            return  # already warm locally
        t0 = time.perf_counter()
        imported, reason, wire_bytes = import_remote_prefix(
            eng, ids, base_url)
        if imported > 0:
            self._count_stream("import", imported, wire_bytes,
                               time.perf_counter() - t0)
        else:
            with self._kv_lock:
                self.disagg_fallbacks[reason or "unknown"] += 1

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "InferenceServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"inference-server-{self.port}")
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._thread is not None:
            self._httpd.shutdown()
        self._httpd.server_close()


# the reference's other flags, their defaults, and the ROADMAP entry that
# ports each; a non-default value exits naming it
_WAITING_FLAGS = {
    "tensor_parallel_size": (1, "slice 6: sharding.py / tp"),
    "sequence_parallel_size": (1, "slice 6: sp_engine.py + ring_attention.py"),
    "sp_min_prompt": (1024, "slice 6: sp_engine.py + ring_attention.py"),
    "migration_chunk_blocks": (4, "preemption, drain and migration"),
    "queue_depth_limit": (0, "preemption, drain and migration (load "
                             "shedding)"),
    "preemption_slo": ("", "preemption, drain and migration"),
    "tls_cert_file": ("", "/metrics and the debug endpoints (TLS)"),
    "tls_key_file": ("", "/metrics and the debug endpoints (TLS)"),
    "debug_token_file": ("", "/metrics and the debug endpoints"),
    "flight_capacity": (512, "/metrics and the debug endpoints"),
    "span_sample_every": (1, "/metrics and the debug endpoints"),
    "slo": ([], "/metrics and the debug endpoints"),
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeinfer-torch-inference-server")
    p.add_argument("--model", required=True,
                   help="preset name (with --random-init)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "bfloat16", "float32"])
    p.add_argument("--max-model-len", type=int, default=0)
    p.add_argument("--random-init", action="store_true",
                   help="serve a randomly initialized --model preset")
    p.add_argument("--batch-slots", type=int, default=8,
                   help="continuous-batching decode slots (0 disables; "
                        "over-slot-width requests use the per-request "
                        "engine)")
    p.add_argument("--prefill-chunk-blocks", type=int, default=4,
                   help="split each slot prefill into chunks of this many "
                        "KV blocks interleaved with decode (0 = whole "
                        "suffix)")
    p.add_argument("--kv-dtype", default="bf16", choices=("bf16", "int8"),
                   help="paged KV pool precision: int8 pages with "
                        "per-(block, kv head) scales hold twice the blocks "
                        "of bf16 in the same memory")
    p.add_argument("--weight-dtype", default="bf16", choices=("bf16", "int8"),
                   help="projection weight precision: int8 quantizes each "
                        "layer's projections as the layer is built")
    p.add_argument("--draft-model", default="",
                   help="draft preset name (with --random-init; seeded 1) "
                        "enabling speculative decoding; must share the "
                        "target's vocabulary")
    p.add_argument("--speculation-depth", type=int, default=4,
                   help="draft tokens proposed per verification round")
    p.add_argument("--speculative-draft", action="store_true",
                   help="run the --draft-model inside the continuous "
                        "batcher's paged batch: k + 1-query verify windows "
                        "with accept/rollback at the window boundary")
    p.add_argument("--prewarm-spec", default="",
                   help="comma-separated draft-group sizes to run once "
                        "before serving (e.g. '1,2,4')")
    p.add_argument("--kv-export-budget-mb", type=float, default=0.0,
                   help="byte budget of the KV export cache served at "
                        "/kv/blocks (0 = bounded by entry count only)")
    # accepted and unused, as in the reference (vLLM flag parity)
    p.add_argument("--gpu-memory-utilization", type=float, default=0.9)
    for name, (default, _entry) in _WAITING_FLAGS.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(default, bool):
            p.add_argument(flag, action="store_true")
        elif isinstance(default, list):
            p.add_argument(flag, action="append", default=[])
        else:
            p.add_argument(flag, type=type(default), default=default)
    return p


def build_server(argv: list[str] | None = None, device=None):
    """Parse flags, build the engines and the server (not started).
    Returns (server, continuous engine or None)."""
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.speculative import SpeculativeEngine

    args = build_parser().parse_args(argv)
    for name, (default, entry) in _WAITING_FLAGS.items():
        if getattr(args, name) != default:
            raise SystemExit(f"--{name.replace('_', '-')} waits: ROADMAP "
                             f"Queue 1, {entry}")
    if not args.random_init:
        raise SystemExit("loading a checkpoint waits: ROADMAP Queue 1, "
                         "checkpoint.py and load_pretrained; pass "
                         "--random-init with a preset --model")
    if args.speculative_draft and not args.draft_model:
        raise SystemExit("--speculative-draft requires --draft-model (the "
                         "paged verify windows run the same draft weights)")
    dcfg = None
    if args.draft_model:
        dcfg = PRESETS.get(args.draft_model)
        if dcfg is None:
            raise SystemExit(
                f"--draft-model {args.draft_model!r} is not a preset (with "
                "--random-init the draft must name one); loading a draft "
                "checkpoint waits: ROADMAP Queue 1, checkpoint.py and "
                "load_pretrained")
    # --model may be a preset name or, when the agent passes its model
    # cache directory, any path: the reference falls back to the CI-sized
    # preset there
    cfg = PRESETS.get(args.model)
    if cfg is None:
        log.info("--random-init: %r is not a preset; using 'tiny'",
                 args.model)
        cfg = PRESETS["tiny"]
    dev = resolve_device(device)
    dtype = {"auto": torch.bfloat16, "bfloat16": torch.bfloat16,
             "float32": torch.float32}[args.dtype]
    params = init_params(cfg, seed=0, dtype=dtype, device=dev,
                         weight_dtype=args.weight_dtype)
    max_cache = args.max_model_len or cfg.max_position_embeddings
    engine = Engine(params, cfg, max_cache_len=max_cache, device=dev)
    speculative = dparams = None
    if dcfg is not None:
        # seeded 1, as the reference draws its draft from PRNGKey(1)
        dparams = init_params(dcfg, seed=1, dtype=dtype, device=dev)
        speculative = SpeculativeEngine(
            params, cfg, dparams, dcfg, k=args.speculation_depth,
            max_cache_len=max_cache, device=dev)
    continuous = None
    if args.batch_slots > 0:
        continuous = ContinuousEngine(
            params, cfg, n_slots=args.batch_slots,
            cache_len=min(max_cache, 4096),
            speculative=speculative,
            prefill_chunk_blocks=args.prefill_chunk_blocks,
            spec_draft=(dparams, dcfg) if args.speculative_draft else None,
            spec_k=args.speculation_depth,
            kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
            device=dev,
        )
        if args.prewarm_spec and speculative is not None:
            sizes = tuple(int(x) for x in args.prewarm_spec.split(",")
                          if x.strip())
            t0 = time.monotonic()
            n = continuous.prewarm_spec(group_sizes=sizes)
            log.info("prewarmed %d draft-group shapes in %.1fs", n,
                     time.monotonic() - t0)
    srv = InferenceServer(engine, model_id=args.model, host=args.host,
                          port=args.port, continuous=continuous,
                          speculative=speculative, device=dev,
                          kv_export_budget_mb=args.kv_export_budget_mb)
    return srv, continuous


def main(argv: list[str] | None = None, device=None) -> int:
    logging.basicConfig(level=logging.INFO)
    srv, continuous = build_server(argv, device)
    if continuous is not None:
        continuous.start()
    srv.start()
    log.info("inference server on port %d (model %s, %s)", srv.port,
             srv.model_id, srv.device)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    while not stop.is_set():
        stop.wait(0.5)
    srv.stop()
    if continuous is not None:
        continuous.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
