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
windows). Routes whose engines wait answer 400 with the reason.

``--model`` names a checkpoint directory (``config.json`` plus
``*.safetensors``, what the node agent's model cache holds), read by
``weights.load_pretrained``; with ``--random-init`` it names a preset
instead. A ``--draft-model`` directory loads the same way. Token-id
prompts always work; string prompts need tokenizer files next to the
weights (``transformers``' ``AutoTokenizer``, imported only when a
checkpoint is loaded; without it the server runs id-only, as the
reference does), and with a tokenizer a completion stops at its EOS.

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
/admin/drain`` stops admissions, and each live session streams its
committed KV chunk by chunk into the same export cache (wire v1/v2 for
chunk 0, v3 after), then completes with ``finish_reason: "migrated"`` and
``kubeinfer.migrated`` (its tokens so far). Another replica finishes it
from a ``kubeinfer_resume: {tokens, kv_source}`` body: it chain-imports
the streamed blocks from the source's ``/kv/blocks`` and decodes the
rest (route "resume"). A draining replica answers new work with 503
``draining``; ``--queue-depth-limit`` sheds with 503 ``overloaded`` and
``Retry-After``; ``--preemption-slo`` lets the batcher park rows for
waiters whose queue wait burns its SLO.

Observability, as in the reference: ``GET /metrics`` (Prometheus text,
open) renders the serving collectors, refreshed from the engines'
counters, the step profiler's records and the SLO monitor at scrape
time; ``GET /cache/summary`` (open) serves the batcher's
``stats_summary()``; ``GET /debug/spans?trace_id=`` (a Chrome trace with
the engine's counter tracks), ``GET /debug/flightrecorder?since=`` and
``GET /debug/slo`` need the bearer token of ``--debug-token-file`` when
one is set, as ``POST /admin/drain`` does. ``--slo NAME:THRESHOLD_S:
OBJECTIVE`` sets the server's SLO objectives, ``--flight-capacity`` the
flight recorder's ring, ``--span-sample-every`` the span head sampling,
and ``--tls-cert-file``/``--tls-key-file`` serve over TLS. Each
completion carries ``kubeinfer: {route, ttft_ms, tpot_ms}`` as the
server's own timeline saw it.

Tensor parallelism, as in the reference: ``--tensor-parallel-size N``
builds one ``(dp=1, tp=N, sp=1)`` mesh (``sharding.make_inference_mesh``:
N visible cards, or N ranks on the CPU with ``--device cpu``), shards the
params and the draft onto it, and gives the batcher, the per-request
engine and the draft that one mesh (``EngineLayout``). ``build_server``
also takes a ``mesh`` from an in-process caller: a mesh of N ranks over
one card runs the sharded path there.

Sequence parallelism, as in the reference: ``--sequence-parallel-size N``
makes that one mesh ``(dp=1, tp, sp=N)`` and builds an ``SPEngine`` on
the (possibly tp-sharded) params; a prompt of at least
``--sp-min-prompt`` tokens takes route ``"sp"`` (after export and
resume, ahead of speculative decoding and the batcher): its prefill
rings over the sp ranks and its decode runs the per-request engine's
loop on the handed-off KV. ``--weight-dtype int8`` with sp > 1 exits, as
in the reference.

    python -m kubeinfer_tpu_torch.inference.server --model /models/meta-llama--Meta-Llama-3-8B
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
    # tensor parallel over two cards (the gauges kubeinfer_engine_tp_degree
    # and kubeinfer_mesh_devices read 2)
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --tensor-parallel-size 2
    # an SLO and a bearer token on /debug/*; then curl localhost:8000/metrics
    python -m kubeinfer_tpu_torch.inference.server --model llama-3-8b --random-init \
        --slo ttft:2.0:0.99 --debug-token-file token.txt

``main(argv, device="cpu")`` (or ``--device cpu``) runs the same server
on the CPU (a rehearsal with ``--model tiny --random-init``).
"""

from __future__ import annotations

import argparse
import json
import logging
import signal
import threading
import time
from http.server import ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.batching import (
    ContinuousEngine,
    EngineDrainingError,
    EngineOverloadedError,
    PreemptionPolicy,
)
from kubeinfer_tpu_torch.inference.sharding import EngineLayout, shard_params
from kubeinfer_tpu_torch.metrics.registry import (
    Counter,
    Gauge,
    Histogram,
    Registry,
)
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.observability.slo import SLOMonitor, SLOObjective
from kubeinfer_tpu_torch.utils.httpbase import (
    BaseEndpointHandler,
    token_matches,
    wrap_server_tls,
)

log = logging.getLogger(__name__)

_TRACER = tracing.get_tracer("inference-server")


def _serving_metrics(registry: Registry):
    """Serving-side collectors (vLLM exposes the equivalents; the
    control plane's collector set lives in metrics/registry.py — these
    are per-inference-server and ride its own /metrics endpoint)."""
    return {
        "requests": Counter(
            "kubeinfer_inference_requests_total",
            "Completion requests by outcome and decode route",
            labels=("route", "outcome"), registry=registry,
        ),
        "prompt_tokens": Counter(
            "kubeinfer_inference_prompt_tokens_total",
            "Prompt tokens received", registry=registry,
        ),
        "completion_tokens": Counter(
            "kubeinfer_inference_completion_tokens_total",
            "Tokens generated", registry=registry,
        ),
        "latency": Histogram(
            "kubeinfer_inference_request_seconds",
            "End-to-end completion latency",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0),
            labels=("route",), registry=registry,
        ),
        # per-request latency breakdown (the vLLM request-metrics plane
        # equivalents): TTFT/queue-wait come from the batcher's own
        # request timeline when the continuous route served the request
        # (t_submit/t_admit/t_first, batching.py _Request); routes with
        # no internal timeline degrade to end-to-end figures — same
        # family, split by the route label
        "ttft": Histogram(
            "kubeinfer_inference_ttft_seconds",
            "Time to first generated token (queue wait + admission + "
            "prefill on the continuous route; end-to-end elsewhere)",
            buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                     10.0, 30.0),
            labels=("route",), registry=registry,
        ),
        "tpot": Histogram(
            "kubeinfer_inference_time_per_output_token_seconds",
            "Mean decode time per generated token after the first",
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                     0.25, 0.5, 1.0),
            labels=("route",), registry=registry,
        ),
        "queue_wait": Histogram(
            "kubeinfer_inference_queue_wait_seconds",
            "Submit-to-admission wait in the continuous batcher",
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                     30.0),
            labels=("route",), registry=registry,
        ),
        # speculation effectiveness, refreshed from the batcher's
        # counters at scrape time
        "spec_served": Gauge(
            "kubeinfer_inference_spec_served_requests",
            "Requests served via speculative draft groups",
            registry=registry,
        ),
        "spec_accepted": Gauge(
            "kubeinfer_inference_spec_accepted_drafts",
            "Draft tokens accepted by the target across all groups",
            registry=registry,
        ),
        # paged speculative decoding (batching.py verify windows, gated
        # by --speculative-draft): the engine's monotonic ints convert
        # to Prometheus counters by delta at scrape time under the kv
        # lock, same discipline as the radix counters below; the ratio
        # gauge is cumulative accepted/proposed so dashboards read the
        # acceptance rate without a PromQL rate-quotient
        "spec_draft_tokens": Counter(
            "kubeinfer_spec_draft_tokens_total",
            "Draft tokens proposed by paged verify windows",
            registry=registry,
        ),
        "spec_accepted_tokens": Counter(
            "kubeinfer_spec_accepted_tokens_total",
            "Proposed draft tokens the target accepted at a window "
            "boundary",
            registry=registry,
        ),
        "spec_rollbacks": Counter(
            "kubeinfer_spec_rollbacks_total",
            "Verify windows that rejected at least one draft token "
            "for some row",
            registry=registry,
        ),
        "spec_acceptance_ratio": Gauge(
            "kubeinfer_spec_acceptance_ratio",
            "Cumulative accepted/proposed draft tokens (0 until the "
            "first window)",
            registry=registry,
        ),
        # paged-KV pool + radix prefix cache (batching.kv_cache_stats):
        # gauges snapshot pool occupancy; the cache counters are
        # Prometheus counters fed by delta at scrape time so restarts
        # of the batcher never make them go backwards mid-series
        "kv_blocks_in_use": Gauge(
            "kubeinfer_kv_blocks_in_use",
            "KV pool blocks referenced by live slots or the prefix cache",
            registry=registry,
        ),
        "kv_blocks_free": Gauge(
            "kubeinfer_kv_blocks_free",
            "KV pool blocks on the free list",
            registry=registry,
        ),
        # device layout of the continuous batcher (sharding.EngineLayout):
        # capacity dashboards need the tp degree next to the pool gauges —
        # a tp=4 replica's blocks_in_use counts LOGICAL blocks whose bytes
        # are split 4 ways, so per-device headroom math divides by tp
        "tp_degree": Gauge(
            "kubeinfer_engine_tp_degree",
            "Tensor-parallel degree of the serving engine's device "
            "layout (1 = unsharded)",
            registry=registry,
        ),
        "mesh_devices": Gauge(
            "kubeinfer_mesh_devices",
            "Devices in the serving mesh (1 when unsharded)",
            registry=registry,
        ),
        "kv_shard_blocks_in_use": Gauge(
            "kubeinfer_kv_shard_blocks_in_use",
            "KV pool blocks referenced per tensor-parallel shard; block "
            "indices are logical, so every shard references the same "
            "block set and holds n_kv/tp heads of each",
            labels=("shard",), registry=registry,
        ),
        "prefix_hits": Counter(
            "kubeinfer_prefix_cache_hits_total",
            "Admits that reused >= 1 cached prefix block",
            registry=registry,
        ),
        "prefix_misses": Counter(
            "kubeinfer_prefix_cache_misses_total",
            "Admits that prefilled from token 0",
            registry=registry,
        ),
        "prefix_evictions": Counter(
            "kubeinfer_prefix_cache_evictions_total",
            "Radix-cache nodes evicted (LRU) to free pool blocks",
            registry=registry,
        ),
        # step-level engine efficiency (batching.StepProfiler): goodput
        # separates "tokens the device produced for someone" from the
        # padded work static shapes force; occupancy/padding-waste say
        # WHY goodput moved (empty slots vs bucket padding). Gauges
        # snapshot the profiler's sliding-window summary at scrape time.
        "goodput": Gauge(
            "kubeinfer_engine_goodput_tokens_per_second",
            "Live (non-padding) tokens produced per second, sliding "
            "window over profiler steps",
            registry=registry,
        ),
        "occupancy": Gauge(
            "kubeinfer_engine_batch_occupancy",
            "Mean live-rows / n_slots over recent decode dispatches",
            registry=registry,
        ),
        "padding_waste": Gauge(
            "kubeinfer_engine_padding_waste_frac",
            "Padded / (live + padded) tokens over recent dispatches",
            registry=registry,
        ),
        "queue_depth": Gauge(
            "kubeinfer_engine_queue_depth",
            "Requests waiting for a slot (submit queue + holdover)",
            registry=registry,
        ),
        "step_duration": Histogram(
            "kubeinfer_engine_step_duration_seconds",
            "Device dispatch wall time by phase (prefill/decode/spec)",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 5.0, 30.0),
            labels=("phase",), registry=registry,
        ),
        "compiles": Counter(
            "kubeinfer_engine_compiles_total",
            "Device dispatches that hit a first-seen (phase, bucket) "
            "shape (the first launch of a shape)",
            registry=registry,
        ),
        # preemptive scheduling + chunked prefill (batching.py): the
        # monotonic engine counters convert by delta at scrape time
        # like the radix counters above; the depth gauges snapshot the
        # scheduler's instantaneous backlog
        "preemptions": Counter(
            "kubeinfer_preemptions_total",
            "Decoding rows parked (blocks cached to the radix trie) to "
            "admit an SLO-pressured waiter",
            registry=registry,
        ),
        "resumes": Counter(
            "kubeinfer_preemption_resumes_total",
            "Parked rows readmitted (radix warm-resume)",
            registry=registry,
        ),
        "chunks": Counter(
            "kubeinfer_prefill_chunks_total",
            "Intermediate chunked-prefill dispatches (excludes the "
            "finalizing bucket dispatch)",
            registry=registry,
        ),
        "chunk_queue": Gauge(
            "kubeinfer_prefill_chunk_queue_depth",
            "Chunked prefills in flight (slot reserved, row not yet "
            "decoding)",
            registry=registry,
        ),
        "parked": Gauge(
            "kubeinfer_parked_requests",
            "Preempted requests awaiting readmission",
            registry=registry,
        ),
        # SLO burn rates (observability/slo.py): burn 1.0 = spending
        # budget exactly at the sustainable rate; the window label keeps
        # the short/long pair an alerting rule needs in one series
        "slo_burn": Gauge(
            "kubeinfer_slo_burn_rate",
            "Error-budget burn rate per objective and window",
            labels=("slo", "window"), registry=registry,
        ),
        "slo_budget": Gauge(
            "kubeinfer_slo_budget_remaining",
            "Signed remaining budget fraction over the longest window",
            labels=("slo",), registry=registry,
        ),
        # disaggregated prefill/decode (disagg/): the KV transfer plane
        # observed from BOTH ends — direction=export counts blocks/bytes
        # served at /kv/blocks, direction=import counts blocks/bytes
        # landed via ContinuousEngine.import_prefix; fallbacks are the
        # paths that degraded to local prefill (token-identical, so a
        # fallback is a latency event, never a correctness one)
        "kv_stream_blocks": Counter(
            "kubeinfer_kv_stream_blocks_total",
            "KV blocks streamed over the transfer plane",
            labels=("direction",), registry=registry,
        ),
        "kv_stream_bytes": Counter(
            "kubeinfer_kv_stream_bytes_total",
            "Wire bytes streamed over the KV transfer plane",
            labels=("direction",), registry=registry,
        ),
        "kv_stream_seconds": Histogram(
            "kubeinfer_kv_stream_seconds",
            "KV transfer-plane operation latency (export = serve the "
            "blob; import = fetch + verify + scatter)",
            buckets=(0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                     1.0, 2.5, 5.0),
            labels=("direction",), registry=registry,
        ),
        "disagg_fallbacks": Counter(
            "kubeinfer_disagg_fallbacks_total",
            "Disaggregated-prefill requests that fell back to local "
            "prefill, by reason",
            labels=("reason",), registry=registry,
        ),
        "kv_pool_bytes": Gauge(
            "kubeinfer_kv_pool_bytes",
            "Resident bytes of the paged KV pool (pages + quant scales "
            "+ bf16 tail buffers), summed across the mesh",
            registry=registry,
        ),
        "model_param_bytes": Gauge(
            "kubeinfer_model_param_bytes",
            "Resident bytes of the model parameters (int8 pages + f32 "
            "scale planes under weight_dtype=int8), summed across the "
            "mesh",
            registry=registry,
        ),
        "requests_shed": Counter(
            "kubeinfer_requests_shed_total",
            "Completion requests refused at the admission door, by "
            "reason (queue_depth_limit = graceful load shedding; the "
            "client got 503 + Retry-After, never a queue slot)",
            labels=("reason",), registry=registry,
        ),
        "kv_quant_blocks": Counter(
            "kubeinfer_kv_quant_blocks_total",
            "KV blocks quantized to int8 on commit (admit-time fills "
            "plus decode/verify boundary crossings; imports excluded)",
            registry=registry,
        ),
        # live-session migration (drain/evacuate/rebalance): sessions
        # handed off with a resume prefix, chunks streamed while decode
        # continued, and the export-cache evictions that tell an
        # operator a slow importer is losing blobs between chunks.
        # Fallbacks are the paths that degraded to (partial) re-prefill
        # — token-identical by the determinism contract, so every one
        # is a latency event, never a correctness one.
        "migrations": Counter(
            "kubeinfer_migrations_total",
            "Live sessions completed as migrated (drain handed them to "
            "the router with a resume prefix)",
            registry=registry,
        ),
        "migration_chunks": Counter(
            "kubeinfer_migration_chunks_total",
            "KV chunks streamed out by drain passes while decode "
            "continued on the source",
            registry=registry,
        ),
        "migration_fallbacks": Counter(
            "kubeinfer_migration_fallbacks_total",
            "Migration resume paths that degraded to (partial) local "
            "re-prefill, by reason",
            labels=("reason",), registry=registry,
        ),
        "kv_export_evictions": Counter(
            "kubeinfer_kv_export_evictions_total",
            "Export-cache blobs evicted (entry cap or bytes budget) "
            "before being pulled",
            registry=registry,
        ),
        "draining": Gauge(
            "kubeinfer_engine_draining_state",
            "1 while the engine refuses new admissions (drain in "
            "progress)",
            registry=registry,
        ),
    }



class InferenceServer:
    def __init__(self, engine, model_id: str, host: str = "127.0.0.1",
                 port: int = 8000, continuous=None, speculative=None,
                 sp=None, device=None, kv_export_budget_mb: float = 0.0,
                 tls_cert: str = "", tls_key: str = "", token: str = "",
                 slo=None, tokenizer=None) -> None:
        self.device = resolve_device(device)
        for e in (engine, continuous, speculative, sp):
            if e is not None and e.device != self.device:
                raise ValueError(f"engine on {e.device}, server on "
                                 f"{self.device}")
        self.engine = engine
        self.continuous = continuous  # ContinuousEngine | None
        self.speculative = speculative  # SpeculativeEngine | None
        self.sp = sp  # SPEngine | None (sequence-parallel long prompts)
        self.model_id = model_id
        self.tokenizer = tokenizer  # an HF tokenizer, or None (id-only)
        # the bearer token of /debug/* and POST /admin/drain (empty =
        # open); /metrics, /health and /cache/summary stay open
        self._token = token
        self.slo = slo if slo is not None else SLOMonitor()
        self.registry = Registry()
        self.metrics = _serving_metrics(self.registry)
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
            # the drain pass streams committed-KV chunks through this sink
            # (scheduler thread, off the engine lock) into the same cache
            # /kv/blocks serves, keyed by each chunk's deepest fingerprint
            continuous.migration_sink = self._export_migration_chunk
            # engine spans name the replica the router registers
            if continuous.replica_name is None:
                continuous.replica_name = model_id
        # the engines' last-seen monotonic counters (the delta-to-Counter
        # conversion at scrape time) and the profiler's replay cursor,
        # under one lock: concurrent scrapes never double-count
        self._kv_last: dict[str, int] = {}
        self._prof_seq = -1
        self._kv_lock = threading.Lock()
        server = self

        class Handler(BaseEndpointHandler):
            def _authed(self) -> bool:
                if not server._token:
                    return True
                return token_matches(self.headers.get("Authorization", ""),
                                     server._token)

            def unauthorized(self) -> None:
                self.respond(401, "application/json",
                             json.dumps({"error": "unauthorized"}))

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                if path.startswith("/debug/") and not self._authed():
                    self.unauthorized()
                    return
                q = parse_qs(urlparse(self.path).query)
                if path == "/health":
                    self.respond(200, "text/plain", "OK")
                elif path == "/metrics":
                    server._refresh_spec_metrics()
                    self.respond(200, "text/plain; version=0.0.4",
                                 server.registry.render())
                elif path == "/v1/models":
                    self.respond(200, "application/json", json.dumps({
                        "object": "list",
                        "data": [{"id": server.model_id, "object": "model",
                                  "owned_by": "kubeinfer-tpu"}],
                    }))
                elif path == "/cache/summary":
                    # fingerprints are one-way hashes of block keys: no
                    # prompt content is recoverable
                    serving = (server.continuous.stats_summary()
                               if server.continuous is not None else {})
                    self.respond(200, "application/json", json.dumps(
                        {"model": server.model_id, "serving": serving}))
                elif path == "/kv/blocks":
                    self.kv_blocks(q)
                elif path == "/debug/spans":
                    # the recorded spans as Chrome trace events (open in
                    # Perfetto), with the engine's counter tracks
                    tid = (q.get("trace_id") or [None])[0]
                    doc = tracing.RECORDER.to_chrome_trace(tid)
                    server._merge_counter_tracks(doc)
                    self.respond(200, "application/json", json.dumps(doc))
                elif path == "/debug/flightrecorder":
                    # ?since= is an exactly-once cursor: events with seq >
                    # since only
                    try:
                        since = int((q.get("since") or ["-1"])[0])
                    except ValueError:
                        self.respond(400, "application/json", json.dumps(
                            {"error": "since must be an integer seq"}))
                        return
                    fl = (server.continuous.flight.to_dict(since)
                          if server.continuous is not None
                          else {"capacity": 0, "recorded": 0, "events": []})
                    self.respond(200, "application/json", json.dumps(fl))
                elif path == "/debug/slo":
                    self.respond(200, "application/json",
                                 json.dumps(server.slo.snapshot()))
                else:
                    self.respond(404, "text/plain", "not found\n")

            def kv_blocks(self, q):
                """One exported prefix by content address (its deepest
                rolling fingerprint); self-verifying on the wire."""
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
                # may scrape the counts
                m = server.metrics
                m["kv_stream_blocks"].inc("export", by=nblocks)
                m["kv_stream_bytes"].inc("export", by=len(blob))
                t0 = time.perf_counter()
                self.respond(200, "application/octet-stream", blob)
                m["kv_stream_seconds"].observe("export",
                                               time.perf_counter() - t0)

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if path == "/admin/drain":
                    # disruptive, so guarded by the /debug/* token
                    if not self._authed():
                        self.unauthorized()
                        return
                    self.admin_drain(raw)
                    return
                if path != "/v1/completions":
                    self.respond(404, "text/plain", "not found\n")
                    return
                # joins the caller's trace when a traceparent came in
                with _TRACER.span("http POST /v1/completions",
                                  parent=self.trace_context()) as sp:
                    self.completion(raw, sp)

            def completion(self, raw: bytes, sp):
                try:
                    try:
                        body = json.loads(raw or b"{}")
                    except ValueError:
                        # malformed JSON never reaches complete()
                        server.metrics["requests"].inc("invalid", "invalid")
                        raise
                    resp = server.complete(body)
                    sp.set(status=200)
                    self.respond(200, "application/json", json.dumps(resp))
                except ValueError as e:
                    sp.set(status=400)
                    self.respond(400, "application/json", json.dumps(
                        {"error": {"message": str(e),
                                   "type": "invalid_request_error"}}))
                except EngineOverloadedError as e:
                    # a valid request with no queue room: back off and retry
                    sp.set(status=503)
                    self.respond(503, "application/json", json.dumps(
                        {"error": {"message": str(e), "type": "overloaded"}}),
                        headers={"Retry-After": str(max(
                            1, int(e.retry_after_s)))})
                except EngineDrainingError as e:
                    # valid, but THIS replica will not take it: route
                    # elsewhere (no Retry-After, a drain does not recover)
                    sp.set(status=503)
                    self.respond(503, "application/json", json.dumps(
                        {"error": {"message": str(e), "type": "draining"}}))
                except Exception as e:  # keep the serving thread alive
                    log.exception("completion failed")
                    sp.set(status=500)
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

        self._httpd = wrap_server_tls(
            ThreadingHTTPServer((host, port), Handler), tls_cert, tls_key)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    # -- scrape ---------------------------------------------------------------

    def _refresh_spec_metrics(self) -> None:
        """Scrape-time refresh of the collectors from the engines' own
        counters: gauges snapshot; the monotonic engine counters convert
        to Prometheus counters by delta, and the profiler's new records
        feed the step histogram once each, under ``_kv_lock``. The SLO
        gauges refresh without a continuous engine too."""
        m = self.metrics
        snap = self.slo.snapshot()
        for name, obj in snap["objectives"].items():
            for w, d in obj["windows"].items():
                m["slo_burn"].set(name, f"{w}s", d["burn_rate"])
            m["slo_budget"].set(name, obj["budget_remaining"])
        eng = self.continuous
        if eng is None:
            return
        m["spec_served"].set(eng.spec_served)
        m["spec_accepted"].set(eng.spec_accepted)
        stats = eng.kv_cache_stats()
        m["kv_blocks_in_use"].set(stats["blocks_in_use"])
        m["kv_blocks_free"].set(stats["blocks_free"])
        m["kv_pool_bytes"].set(stats["pool_bytes"])
        m["model_param_bytes"].set(eng.model_param_bytes)
        summary = eng.stats_summary()
        # one series per tp shard, all the same logical count: the pool's
        # bookkeeping is layout-agnostic, so a shard's referenced blocks
        # are the pool's
        m["tp_degree"].set(summary["tp_degree"])
        m["mesh_devices"].set(summary["mesh_devices"])
        for shard in range(summary["tp_degree"]):
            m["kv_shard_blocks_in_use"].set(str(shard),
                                            stats["blocks_in_use"])
        m["goodput"].set(summary["goodput_tokens_per_sec"])
        m["occupancy"].set(summary["batch_occupancy"])
        m["padding_waste"].set(summary["padding_waste_frac"])
        m["queue_depth"].set(summary["queue_depth"])
        m["draining"].set(1.0 if summary["draining"] else 0.0)
        sched = eng.scheduler_stats()
        m["chunk_queue"].set(sched["chunk_queue"])
        m["parked"].set(sched["parked"])
        with self._kv_lock:
            # a zero delta still materializes the series (at 0)
            for src, key, name in (
                    (stats, "hits", "prefix_hits"),
                    (stats, "misses", "prefix_misses"),
                    (stats, "evictions", "prefix_evictions"),
                    (stats, "quant_blocks", "kv_quant_blocks"),
                    (sched, "preempted", "preemptions"),
                    (sched, "resumed", "resumes"),
                    (sched, "chunks", "chunks"),
                    (sched, "spec_draft_tokens", "spec_draft_tokens"),
                    (sched, "spec_accepted_tokens", "spec_accepted_tokens"),
                    (sched, "spec_rollbacks", "spec_rollbacks"),
                    (sched, "migrated", "migrations"),
                    (sched, "migration_chunks", "migration_chunks")):
                m[name].inc(by=src[key] - self._kv_last.get(key, 0))
                self._kv_last[key] = src[key]
            if self.kv_exports is not None:
                ev = self.kv_exports.stats()["evictions"]
                m["kv_export_evictions"].inc(
                    by=ev - self._kv_last.get("export_evictions", 0))
                self._kv_last["export_evictions"] = ev
            # from the cumulative ints: a scrape between windows must not
            # flap the gauge to 0/0
            m["spec_acceptance_ratio"].set(
                sched["spec_accepted_tokens"]
                / max(sched["spec_draft_tokens"], 1))
            m["compiles"].inc(by=0)
            recs = eng.profiler.snapshot(since_seq=self._prof_seq)
            for r in recs:
                m["step_duration"].observe(r.phase, r.dur_s)
                if r.compiled:
                    m["compiles"].inc()
            if recs:
                self._prof_seq = recs[-1].seq

    def _merge_counter_tracks(self, doc: dict) -> None:
        """Append the engine's counter tracks (batch occupancy, padded
        tokens, queue depth, kv blocks) to a Chrome trace as one more
        process, ``engine-counters``. No-op without a continuous
        engine."""
        if self.continuous is None:
            return
        events = doc.get("traceEvents", [])
        pid = max((e.get("pid", 0) for e in events), default=0) + 1
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": "engine-counters"}})
        events.extend(self.continuous.profiler.counter_events(pid))
        events.extend(self.continuous.flight.counter_events(pid))
        doc["traceEvents"] = events

    # -- request handling --------------------------------------------------

    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, list):
            if not all(isinstance(t, int) for t in prompt):
                raise ValueError("prompt list must contain token ids (ints)")
            return prompt
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError(
                    "string prompts require tokenizer files next to the "
                    "model weights; this server was started without them "
                    "— send token ids instead")
            return self.tokenizer.encode(prompt)
        raise ValueError("prompt must be a string or a list of token ids")

    def _eos_id(self) -> int:
        tok = self.tokenizer
        if tok is not None and tok.eos_token_id is not None:
            return int(tok.eos_token_id)
        return -1

    def _decode(self, ids: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(str(i) for i in ids)
        return self.tokenizer.decode(ids)

    def complete(self, body: dict) -> dict:
        # _complete names the route as soon as it picks one, so a failure
        # during generation still counts under its route
        route_box = {"route": "invalid"}
        t0 = time.perf_counter()
        with _TRACER.span("server.complete", replica=self.model_id) as span:
            try:
                if not isinstance(body, dict):
                    raise ValueError("request body must be a JSON object")
                ids, gen = self._complete(body, route_box)
            except ValueError:
                self.metrics["requests"].inc(route_box["route"], "invalid")
                raise
            except Exception as e:
                if isinstance(e, EngineOverloadedError):
                    self.metrics["requests_shed"].inc("queue_depth_limit")
                    outcome = "shed"
                elif isinstance(e, EngineDrainingError):
                    outcome = "draining"
                else:
                    outcome = "error"
                self.metrics["requests"].inc(route_box["route"], outcome)
                raise
            finally:
                span.set(route=route_box["route"])
        route = route_box["route"]
        dur = time.perf_counter() - t0
        m = self.metrics
        m["requests"].inc(route, "ok")
        m["latency"].observe(route, dur)
        m["prompt_tokens"].inc(by=len(ids))
        m["completion_tokens"].inc(by=len(gen))
        req = route_box.get("timing")
        ttft, tpot = self._observe_breakdown(route, dur, len(gen), req)
        ext = route_box.get("ext") or {}
        # "stop" iff the sequence ended on EOS (the tokenizer's; none
        # without one), "migrated" when a drain handed it off (its tokens
        # are a prefix of the answer)
        eos_id = self._eos_id()
        stopped = eos_id >= 0 and bool(gen) and gen[-1] == eos_id
        finish = "stop" if stopped else "length"
        if ext.get("migrated") is not None:
            finish = "migrated"
        # the continuous routes' completion id carries the flight ring's
        # request id (detail key "req")
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
                "prompt_tokens": len(ids),
                "completion_tokens": len(gen),
                "total_tokens": len(ids) + len(gen),
            },
            # the serving timeline as the SERVER saw it
            "kubeinfer": {"route": route, "ttft_ms": round(ttft * 1e3, 3),
                          "tpot_ms": round(tpot * 1e3, 3), **ext},
        }

    def _observe_breakdown(self, route: str, total_s: float, n_out: int,
                           req=None) -> tuple[float, float]:
        """The latency-breakdown histograms and the SLO monitor: the
        continuous routes' request timeline (stamped by the scheduler)
        gives queue wait, TTFT and TPOT; the other routes degrade to the
        end-to-end time and its mean a token. Returns (ttft, tpot) s."""
        m = self.metrics
        ttft = total_s
        decode_s = None
        if req is not None and req.t_submit:
            if req.t_admit:
                wait = max(0.0, req.t_admit - req.t_submit)
                m["queue_wait"].observe(route, wait)
                self.slo.observe("queue_wait", wait)
            end = req.t_done or req.t_submit + total_s
            if req.t_first:
                ttft = max(0.0, req.t_first - req.t_submit)
                decode_s = max(0.0, end - req.t_first)
            else:  # a draft group, or a session migrated unadmitted
                ttft = max(0.0, end - req.t_submit)
        m["ttft"].observe(route, ttft)
        self.slo.observe("ttft", ttft)
        if decode_s is not None and n_out > 1:
            tpot = decode_s / (n_out - 1)
        else:
            tpot = total_s / max(1, n_out)
        m["tpot"].observe(route, tpot)
        self.slo.observe("tpot", tpot)
        return ttft, tpot

    def _complete(self, body: dict, route_box: dict):
        """Route one completion; returns (prompt ids, generated tokens)
        and leaves the route, the continuous request (``timing``) and the
        ``kubeinfer`` extras (``ext``) in ``route_box``."""
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
        eos_id = self._eos_id()
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
            return ids, self._prefill_only(ids, kw, route_box)
        if resume_tokens:
            return ids, self._resume(ids, max_tokens, resume_tokens, resume,
                                     kw, route_box)
        if self.sp is not None and self.sp.fits(len(ids), max_tokens):
            # a long prompt rings its prefill over the mesh's sp ranks and
            # decodes from the handed-off KV; below --sp-min-prompt the
            # collective traffic is not worth it
            route_box["route"] = "sp"
            out = self.sp.generate([ids], max_new_tokens=max_tokens, **kw)
            return ids, out.tokens[0, : out.lengths[0]].tolist()
        if (self.speculative is not None and rep_penalty == 1.0
                and self.speculative.fits(len(ids), max_tokens)
                # a batcher with a speculative engine owns the draft-
                # eligible traffic it fits (its groups, or verify windows)
                and not (self.continuous is not None
                         and self.continuous.speculative is not None
                         and self.continuous.fits(len(ids), max_tokens))):
            route_box["route"] = "speculative"
            kw.pop("repetition_penalty")
            out = self.speculative.generate([ids], max_new_tokens=max_tokens,
                                            **kw)
            return ids, out.tokens[0, : out.lengths[0]].tolist()
        if self.continuous is not None and self.continuous.fits(
                len(ids), max_tokens):
            route_box["route"] = "continuous"
            req = self.continuous.serve(ids, max_new_tokens=max_tokens, **kw)
            self._ext(req, route_box)
            return ids, list(req.out_tokens)
        route_box["route"] = "engine"
        out = self.engine.generate([ids], max_new_tokens=max_tokens, **kw)
        return ids, out.tokens[0, : out.lengths[0]].tolist()

    @staticmethod
    def _ext(req, route_box: dict) -> None:
        """A continuous request's timeline, and ``migrated`` when the
        engine drained under it (the router re-routes with these tokens
        as the resume prefix, pulling the chain from /kv/blocks)."""
        route_box["timing"] = req
        if req.migrated is not None:
            route_box["ext"] = {"migrated": dict(req.migrated)}

    def _resume(self, ids: list[int], max_tokens: int,
                resume_tokens: list[int], resume: dict, kw: dict,
                route_box: dict) -> list[int]:
        """Finish a migrated session: only the continuous batcher's
        position-folded key schedule reproduces the source's stream
        mid-generation. A tail the source already finished answers
        directly; else the committed chain is chain-imported from
        ``kv_source`` (best-effort) and the batcher readmits the rest."""
        if not (self.continuous is not None
                and self.continuous.fits(len(ids), max_tokens)):
            raise ValueError("kubeinfer_resume requires the continuous "
                             "batcher and a prompt that fits its cache")
        route_box["route"] = "resume"
        eos_id = kw["eos_id"]
        if len(resume_tokens) >= max_tokens or (
                eos_id >= 0 and resume_tokens[-1] == eos_id):
            # the source finished before the hand-off completed
            return resume_tokens[:max_tokens]
        src = resume.get("kv_source")
        if isinstance(src, str) and src:
            # the committed chain only: the newest token's KV never
            # streamed
            self._maybe_import_chain((ids + resume_tokens)[:-1], src)
        req = self.continuous.serve(ids, max_new_tokens=max_tokens,
                                    resume_tokens=resume_tokens, **kw)
        # drained AGAIN mid-resume: migrated carries on to the next hop
        self._ext(req, route_box)
        return list(req.out_tokens)

    def _prefill_only(self, ids: list[int], kw: dict,
                      route_box: dict) -> list[int]:
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

        route_box["route"] = "prefill"
        req = self.continuous.serve(ids, max_new_tokens=0, export_kv=True,
                                    **kw)
        route_box["timing"] = req
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
                route_box["ext"] = {"kv_export": {
                    "fingerprint": int(fp),
                    "blocks": len(exp["fingerprints"]),
                    "bytes": len(blob)}}
        return []

    def _count_import(self, imported: int, wire_bytes: int,
                      t0: float) -> None:
        m = self.metrics
        m["kv_stream_blocks"].inc("import", by=imported)
        m["kv_stream_bytes"].inc("import", by=wire_bytes)
        m["kv_stream_seconds"].observe("import", time.perf_counter() - t0)

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
        # the fetch + verify + staged write, under server.complete
        with _TRACER.span("server.kv_import", kind="prefix",
                          replica=self.model_id) as sp:
            imported, reason, wire_bytes = import_remote_prefix(
                eng, ids, base_url)
            sp.set(blocks=imported,
                   **({"fallback": reason} if reason else {}))
        if imported > 0:
            self._count_import(imported, wire_bytes, t0)
        else:
            self.metrics["disagg_fallbacks"].inc(reason or "unknown")

    def _maybe_import_chain(self, tokens: list[int], base_url: str) -> None:
        """Chunked warm import of a migrated session's KV chain from the
        source replica before the resume admit. Best-effort: a failure
        counts under ``kubeinfer_migration_fallbacks_total``, and a
        partial import still counts its blocks (the resume re-prefills
        only past the last verified chunk). A chain whose deepest
        fingerprint the engine already advertises (a bounce-back resume)
        is not fetched."""
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
        with _TRACER.span("server.kv_import", kind="chain",
                          replica=self.model_id) as sp:
            imported, reason, wire_bytes = import_remote_chain(
                eng, tokens, base_url,
                chunk_blocks=eng.migration_chunk_blocks)
            sp.set(blocks=imported,
                   **({"fallback": reason} if reason else {}))
        if imported > 0:
            self._count_import(imported, wire_bytes, t0)
        if reason is not None:
            self.metrics["migration_fallbacks"].inc(reason)

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="kubeinfer-torch-inference-server")
    p.add_argument("--model", required=True,
                   help="checkpoint directory (config.json + "
                        "*.safetensors), or a preset name with "
                        "--random-init")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--dtype", default="auto",
                   choices=["auto", "bfloat16", "float32"])
    p.add_argument("--max-model-len", type=int, default=0)
    p.add_argument("--random-init", action="store_true",
                   help="serve a randomly initialized --model preset "
                        "instead of loading a checkpoint")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="shard the model over this many tp ranks (visible "
                        "cards; CPU ranks with --device cpu)")
    p.add_argument("--sequence-parallel-size", type=int, default=1,
                   help="shard long-prompt prefill over this many mesh "
                        "ranks via ring attention (sp_engine.py); "
                        "requests below --sp-min-prompt keep the normal "
                        "routes")
    p.add_argument("--sp-min-prompt", type=int, default=1024,
                   help="minimum prompt length (tokens) routed through "
                        "the sequence-parallel engine")
    p.add_argument("--device", default=None,
                   help="cuda (the default, the card; fails without one) "
                        "or cpu (the plain PyTorch versions, for tests)")
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
                   help="draft checkpoint directory (a preset name with "
                        "--random-init, seeded 1) enabling speculative "
                        "decoding; must share the target's vocabulary")
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
    p.add_argument("--tls-cert-file", default="",
                   help="serve completions over TLS (PEM cert; key via "
                        "--tls-key-file)")
    p.add_argument("--tls-key-file", default="")
    p.add_argument("--debug-token-file", default="",
                   help="file holding the bearer token required on "
                        "/debug/* (spans, flight recorder, SLO) and POST "
                        "/admin/drain; empty leaves them open")
    p.add_argument("--flight-capacity", type=int, default=512,
                   help="flight-recorder ring size (scheduler decisions "
                        "kept for /debug/flightrecorder)")
    p.add_argument("--span-sample-every", type=int, default=1,
                   help="record spans for 1 in N traces (head sampling, "
                        "whole traces kept or dropped together; 1 = record "
                        "all); every metric still counts every request")
    p.add_argument("--slo", action="append", default=[],
                   metavar="NAME:THRESHOLD_S:OBJECTIVE",
                   help="SLO objective, repeatable (e.g. ttft:0.5:0.99 = "
                        "99%% of requests see their first token in 500 "
                        "ms); names: ttft, tpot, queue_wait. Default: the "
                        "loose built-ins of observability/slo.py")
    # accepted and unused, as in the reference (vLLM flag parity)
    p.add_argument("--gpu-memory-utilization", type=float, default=0.9)
    return p


def _load_tokenizer(model_dir: str):
    """The checkpoint's HF tokenizer, or None (id-only), as the
    reference loads it: ``transformers`` is imported only here."""
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(model_dir)
    except Exception as e:
        log.warning("no tokenizer loaded from %s (%s); id-only mode",
                    model_dir, e)
        return None


def _serving_mesh(tp: int, sp: int, dev: torch.device, mesh):
    """The serving mesh of ``--tensor-parallel-size`` ``tp`` and
    ``--sequence-parallel-size`` ``sp`` (None when both are 1): ``mesh``
    when a caller gave one, else ``tp * sp`` CPU ranks for the CPU, else
    ``tp * sp`` visible cards (raising when there are fewer)."""
    from kubeinfer_tpu_torch.inference.sharding import (
        make_inference_mesh,
        same_device,
    )

    if tp < 1:
        raise SystemExit(f"--tensor-parallel-size must be >= 1, got {tp}")
    if sp < 1:
        raise SystemExit(f"--sequence-parallel-size must be >= 1, got {sp}")
    if mesh is None:
        if tp == sp == 1:
            return None
        if dev.type == "cpu":
            return make_inference_mesh(tp=tp, sp=sp, dp=1,
                                       devices=[dev] * (tp * sp))
        return make_inference_mesh(tp=tp, sp=sp, dp=1)
    if (mesh.shape.get("tp") != tp or mesh.shape.get("sp", 1) != sp
            or mesh.size != tp * sp):
        raise ValueError(f"--tensor-parallel-size {tp} and "
                         f"--sequence-parallel-size {sp} but the mesh is "
                         f"{mesh.shape}")
    if not same_device(mesh.axis_devices("tp")[0], dev):
        raise ValueError(f"the mesh starts on {mesh.axis_devices('tp')[0]}, "
                         f"the server runs on {dev}")
    return mesh


def build_server(argv: list[str] | None = None, device=None, mesh=None):
    """Parse flags, build the engines and the server (not started).
    ``device`` (else ``--device``, else the card) places everything;
    under ``--tensor-parallel-size N`` the params shard over ``mesh``
    (a ``sharding.Mesh`` with N tp ranks starting on that device), or
    over N ranks the flags name when no mesh is given; under
    ``--sequence-parallel-size`` that mesh's sp ranks serve the long
    prompts (``SPEngine``). Returns (server, continuous engine or
    None)."""
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.engine import Engine
    from kubeinfer_tpu_torch.inference.model import init_params
    from kubeinfer_tpu_torch.inference.speculative import SpeculativeEngine
    from kubeinfer_tpu_torch.inference.weights import load_pretrained

    args = build_parser().parse_args(argv)
    if args.weight_dtype == "int8" and args.sequence_parallel_size > 1:
        # the reference's SP engine has no quantized-leaf path either
        raise SystemExit("--weight-dtype int8 does not compose with "
                         "--sequence-parallel-size > 1 yet")
    if args.speculative_draft and not args.draft_model:
        raise SystemExit("--speculative-draft requires --draft-model (the "
                         "paged verify windows run the same draft weights)")
    if args.span_sample_every != 1:
        # process-global: every tracer of the process keeps or drops the
        # same traces
        tracing.set_span_sampling(args.span_sample_every)
    debug_token = ""
    if args.debug_token_file:
        with open(args.debug_token_file, encoding="utf-8") as f:
            debug_token = f.read().strip()
    slo = None
    if args.slo:
        slo = SLOMonitor(
            objectives=tuple(SLOObjective.parse(x) for x in args.slo))
    dcfg = None
    if args.draft_model and args.random_init:
        dcfg = PRESETS.get(args.draft_model)
        if dcfg is None:
            raise SystemExit(
                f"--draft-model {args.draft_model!r} is not a preset (with "
                "--random-init the draft must name one)")
    dev = resolve_device(device if device is not None else args.device)
    mesh = _serving_mesh(args.tensor_parallel_size,
                         args.sequence_parallel_size, dev, mesh)
    if mesh is not None:
        dev = mesh.axis_devices("tp")[0]
    dtype = {"auto": torch.bfloat16, "bfloat16": torch.bfloat16,
             "float32": torch.float32}[args.dtype]
    tokenizer = None
    if args.random_init:
        # --model may be a preset name or, when the agent passes its
        # model cache directory, any path: the reference falls back to
        # the CI-sized preset there
        cfg = PRESETS.get(args.model)
        if cfg is None:
            log.info("--random-init: %r is not a preset; using 'tiny'",
                     args.model)
            cfg = PRESETS["tiny"]
        params = init_params(cfg, seed=0, dtype=dtype, device=dev,
                             weight_dtype=args.weight_dtype)
    else:
        t0 = time.monotonic()
        params, cfg = load_pretrained(args.model, dtype=dtype,
                                      weight_dtype=args.weight_dtype,
                                      device=dev)
        log.info("loaded %s (%d layers, %s weights) in %.1fs", args.model,
                 cfg.num_hidden_layers, args.weight_dtype,
                 time.monotonic() - t0)
        tokenizer = _load_tokenizer(args.model)
    max_cache = args.max_model_len or cfg.max_position_embeddings
    layout = None
    if args.tensor_parallel_size > 1:
        # one mesh for the batcher, the per-request engine, the draft and
        # the sp engine
        layout = EngineLayout(tp=args.tensor_parallel_size, mesh=mesh)
        layout.check_model(cfg)
        params = shard_params(params, mesh, cfg)
    sp_engine = None
    if args.sequence_parallel_size > 1:
        from kubeinfer_tpu_torch.inference.sp_engine import SPEngine

        sp_engine = SPEngine(params, cfg, mesh, max_cache_len=max_cache,
                             min_prompt=args.sp_min_prompt)
    engine = Engine(params, cfg, max_cache_len=max_cache, device=dev)
    speculative = dparams = None
    if args.draft_model:
        if dcfg is not None:
            # seeded 1, as the reference draws its draft from PRNGKey(1)
            dparams = init_params(dcfg, seed=1, dtype=dtype, device=dev)
        else:
            dparams, dcfg = load_pretrained(args.draft_model, dtype=dtype,
                                            device=dev)
        if layout is not None:
            # the draft shards onto the same mesh (the batcher's verify
            # route replicates it, as the reference's does)
            dparams = shard_params(dparams, mesh, dcfg)
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
            flight_capacity=args.flight_capacity,
            layout=layout,
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
                          speculative=speculative, sp=sp_engine, device=dev,
                          kv_export_budget_mb=args.kv_export_budget_mb,
                          tls_cert=args.tls_cert_file,
                          tls_key=args.tls_key_file, token=debug_token,
                          slo=slo, tokenizer=tokenizer)
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
