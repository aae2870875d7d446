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

Drain and live-session migration, as in the reference: ``POST
/admin/drain`` (open, as a reference server with no bearer token is)
stops admissions, and each live session streams its committed KV
chunk by chunk into the same export cache (wire v1/v2 for chunk 0, v3
after), then completes with ``finish_reason: "migrated"`` and
``kubeinfer.migrated`` (its tokens so far). Another replica finishes it
from a ``kubeinfer_resume: {tokens, kv_source}`` body: it chain-imports
the streamed blocks from the source's ``/kv/blocks`` and decodes the
rest (route "resume"). A draining replica answers new work with 503
``draining``; ``--queue-depth-limit`` sheds with 503 ``overloaded`` and
``Retry-After``; ``--preemption-slo`` lets the batcher park rows for
waiters whose queue wait burns its SLO.

    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --kv-dtype int8 --weight-dtype int8
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --draft-model llama-3-8b --speculative-draft --speculation-depth 4
    # two replicas: POST {"prompt": [...], "max_tokens": 0} to :8001, then
    # the same prompt with "kubeinfer_kv_source": "http://127.0.0.1:8001"
    # (and max_tokens > 0) to :8002; POST /admin/drain to :8001 hands its
    # live sessions off, each resumed on :8002 with
    # "kubeinfer_resume": {"tokens": [...], "kv_source": "http://127.0.0.1:8001"}
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
from kubeinfer_tpu_torch.inference.batching import (
    ContinuousEngine,
    EngineDrainingError,
    EngineOverloadedError,
    PreemptionPolicy,
)

log = logging.getLogger(__name__)


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
        # chain imports of migrated sessions that fell short, by reason (a
        # partial import still counts its blocks above)
        self.migration_fallbacks: collections.Counter = collections.Counter()
        self._kv_lock = threading.Lock()
        if self.kv_exports is not None:
            # the drain pass streams committed-KV chunks through this sink
            # (scheduler thread, off the engine lock) into the same cache
            # /kv/blocks serves, keyed by each chunk's deepest fingerprint
            continuous.migration_sink = self._export_migration_chunk
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # no per-request stderr
                return

            def respond(self, code: int, ctype: str, body,
                        headers: dict | None = None) -> None:
                data = body.encode() if isinstance(body, str) else body
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for key, value in (headers or {}).items():
                    self.send_header(key, value)
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
                if path == "/admin/drain":
                    self.admin_drain(raw)
                    return
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
                except EngineOverloadedError as e:
                    # a valid request with no queue room: back off and retry
                    self.respond(503, "application/json", json.dumps(
                        {"error": {"message": str(e), "type": "overloaded"}}),
                        headers={"Retry-After": str(max(
                            1, int(e.retry_after_s)))})
                except EngineDrainingError as e:
                    # valid, but THIS replica will not take it: route
                    # elsewhere (no Retry-After, a drain does not recover)
                    self.respond(503, "application/json", json.dumps(
                        {"error": {"message": str(e), "type": "draining"}}))
                except Exception as e:  # keep the serving thread alive
                    log.exception("completion failed")
                    self.respond(500, "application/json", json.dumps(
                        {"error": {"message": str(e),
                                   "type": "server_error"}}))

            def admin_drain(self, raw: bytes):
                """``POST /admin/drain {"resume": bool, "timeout_s": s}``;
                a body that is not a JSON object counts as ``{}``."""
                try:
                    body = json.loads(raw or b"{}")
                except ValueError:
                    body = {}
                if not isinstance(body, dict):
                    body = {}
                try:
                    resp = server.drain(
                        resume=bool(body.get("resume", False)),
                        timeout_s=float(body.get("timeout_s", 30.0)))
                except ValueError as e:
                    self.respond(400, "application/json", json.dumps(
                        {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}))
                    return
                self.respond(200, "application/json", json.dumps(resp))

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
            if req.t_first:  # (none for a session migrated unadmitted)
                ext["ttft_ms"] = (req.t_first - req.t_submit) * 1e3
            if self.continuous.spec_draft is not None:
                # the verify route's per-request accounting (the
                # reference records it on its engine.decode span)
                ext["spec_accepted"] = req.spec_accepted
                ext["spec_rollbacks"] = req.spec_rollbacks
        ids_len = len(body["prompt"])
        # no tokenizer, so no EOS: every completion runs to length, unless
        # a drain handed it off (its tokens are a prefix of the answer)
        finish = "migrated" if "migrated" in ext else "length"
        return {
            "id": "cmpl-kubeinfer" if req is None
            else f"cmpl-kubeinfer-{req.rid}",
            "object": "text_completion",
            "model": self.model_id,
            "choices": [{
                "index": 0,
                "text": self._decode(gen),
                "tokens": gen,
                "finish_reason": finish,
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
        # live-session resume: a drained source handed back its tokens so
        # far (and where to pull the streamed KV chain from)
        resume = body.get("kubeinfer_resume")
        resume_tokens: list[int] = []
        if resume is not None:
            if not isinstance(resume, dict):
                raise ValueError("kubeinfer_resume must be an object")
            rt = resume.get("tokens") or []
            if not (isinstance(rt, list)
                    and all(isinstance(t, int) for t in rt)):
                raise ValueError(
                    "kubeinfer_resume.tokens must be token ids (ints)")
            resume_tokens = [int(t) for t in rt]
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
        if resume_tokens:
            return self._resume(ids, max_tokens, resume_tokens, resume, kw)
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
            return "continuous", list(req.out_tokens), req, self._ext(req)
        out = self.engine.generate([ids], max_new_tokens=max_tokens, **kw)
        return "engine", out.tokens[0, : out.lengths[0]].tolist(), None, {}

    @staticmethod
    def _ext(req) -> dict:
        """A continuous request's extra fields: ``migrated`` when the
        engine drained under it (the router re-routes with these tokens
        as the resume prefix, pulling the chain from /kv/blocks)."""
        return {"migrated": dict(req.migrated)} if req.migrated else {}

    def _resume(self, ids: list[int], max_tokens: int,
                resume_tokens: list[int], resume: dict, kw: dict):
        """Finish a migrated session: only the continuous batcher's
        position-folded key schedule reproduces the source's stream
        mid-generation. A tail the source already finished answers
        directly; else the committed chain is chain-imported from
        ``kv_source`` (best-effort) and the batcher readmits the rest."""
        if not (self.continuous is not None
                and self.continuous.fits(len(ids), max_tokens)):
            raise ValueError("kubeinfer_resume requires the continuous "
                             "batcher and a prompt that fits its cache")
        if len(resume_tokens) >= max_tokens:
            return "resume", resume_tokens[:max_tokens], None, {}
        src = resume.get("kv_source")
        if isinstance(src, str) and src:
            # the committed chain only: the newest token's KV never
            # streamed
            self._maybe_import_chain((ids + resume_tokens)[:-1], src)
        req = self.continuous.serve(ids, max_new_tokens=max_tokens,
                                    resume_tokens=resume_tokens, **kw)
        # drained AGAIN mid-resume: migrated carries on to the next hop
        return "resume", list(req.out_tokens), req, self._ext(req)

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

    def _maybe_import_chain(self, tokens: list[int], base_url: str) -> None:
        """Chunked warm import of a migrated session's KV chain from the
        source replica before the resume admit. Best-effort: a failure
        counts under ``migration_fallbacks``, and a partial import still
        counts its blocks (the resume re-prefills only past the last
        verified chunk). A chain whose deepest fingerprint the engine
        already advertises (a bounce-back resume) is not fetched."""
        from kubeinfer_tpu_torch.disagg.client import import_remote_chain
        from kubeinfer_tpu_torch.inference.kv_blocks import (
            prefix_fingerprints,
        )

        eng = self.continuous
        fps = prefix_fingerprints(tokens, eng.block_size)
        if not fps:
            return
        if fps[-1] in set(eng.cache_summary().get("fingerprints", [])):
            return  # the whole chain is warm here already
        t0 = time.perf_counter()
        imported, reason, wire_bytes = import_remote_chain(
            eng, tokens, base_url, chunk_blocks=eng.migration_chunk_blocks)
        if imported > 0:
            self._count_stream("import", imported, wire_bytes,
                               time.perf_counter() - t0)
        if reason is not None:
            with self._kv_lock:
                self.migration_fallbacks[reason] += 1

    def _export_migration_chunk(self, chunk: dict) -> None:
        """The engine's migration sink (scheduler thread, off the engine
        lock): wire-encode one streamed chunk (chunk 0 as v1/v2, later
        ones as v3) and park it in the export cache under the chunk's own
        deepest fingerprint, where ``/kv/blocks`` serves it. Raising is
        fine: the engine then hands the session off with what already
        streamed. Export blocks and bytes count when /kv/blocks serves
        the blob."""
        from kubeinfer_tpu_torch.disagg.wire import encode_payload

        blob = encode_payload(
            chunk["pages_k"], chunk["pages_v"], chunk["fingerprints"],
            chunk["block_size"], scales_k=chunk.get("scales_k"),
            scales_v=chunk.get("scales_v"),
            kv_dtype=chunk.get("kv_dtype", "bf16"),
            start_block=chunk["start_block"])
        self.kv_exports.put(int(chunk["fingerprints"][-1]), blob)

    def drain(self, resume: bool = False, timeout_s: float = 30.0) -> dict:
        """``POST /admin/drain``: stop admitting, migrate or complete
        every live session, report. ``resume=True`` (a rebalance) undrains
        once drained. Blocks up to ``timeout_s``; ``drained`` false means
        sessions are still live."""
        if self.continuous is None:
            raise ValueError("drain requires the continuous batcher")
        eng = self.continuous
        before = eng.migrated_total
        eng.drain()
        drained = eng.wait_drained(timeout_s)
        sched = eng.scheduler_stats()
        out = {
            "drained": bool(drained),
            "draining": True,
            "migrated": int(eng.migrated_total - before),
            "migration_chunks_total": int(sched["migration_chunks"]),
            "migration_blocks_total": int(sched["migration_blocks"]),
            "exports": (self.kv_exports.stats()
                        if self.kv_exports is not None else {}),
        }
        if resume and drained:
            eng.undrain()
            out["draining"] = False
        return out

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
                        "/kv/blocks, prefill exports and migration chunks "
                        "(0 = bounded by entry count only)")
    p.add_argument("--migration-chunk-blocks", type=int, default=4,
                   help="KV blocks streamed per drain pass during live-"
                        "session migration; decode windows run between "
                        "chunks")
    p.add_argument("--queue-depth-limit", type=int, default=0,
                   help="shed completion submits with 503 + Retry-After "
                        "once waiting work (queue + holdover + parked) "
                        "reaches this depth (0 = unbounded)")
    p.add_argument("--preemption-slo", default="",
                   metavar="THRESHOLD_S[:BURN_LIMIT]",
                   help="park the youngest decoding row (its KV cached in "
                        "the radix trie, a token-identical warm readmit) "
                        "when a waiter exceeds THRESHOLD_S and the "
                        "queue-wait burn rate reaches BURN_LIMIT (default "
                        "1.0); empty disables preemption")
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
        preemption = None
        if args.preemption_slo:
            preemption = PreemptionPolicy.parse(args.preemption_slo)
        continuous = ContinuousEngine(
            params, cfg, n_slots=args.batch_slots,
            cache_len=min(max_cache, 4096),
            speculative=speculative,
            prefill_chunk_blocks=args.prefill_chunk_blocks,
            spec_draft=(dparams, dcfg) if args.speculative_draft else None,
            spec_k=args.speculation_depth,
            kv_dtype=args.kv_dtype, weight_dtype=args.weight_dtype,
            preemption=preemption,
            queue_depth_limit=args.queue_depth_limit,
            migration_chunk_blocks=args.migration_chunk_blocks,
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
