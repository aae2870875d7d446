"""HTTP transport for the control-plane store — the API-server wire protocol.

The reference control plane is the Kubernetes API server: the manager and
every agent reach it over HTTPS with ServiceAccount bearer tokens
(cmd/agent/main.go:56-63 in-cluster config; cmd/manager/main.go:157
GetConfigOrDie). kubeinfer_tpu is standalone, so the manager process *hosts*
the store (``StoreServer``) and agents/CLIs reach it through ``RemoteStore``,
which implements the exact same interface as the in-process ``Store``
(create/get/update/delete/list/watch) so every component runs unchanged
in-process (tests, e2e slice) or cross-process (real deployment).

Protocol (JSON over HTTP/1.1):

- ``GET  /healthz``                         liveness, unauthenticated
- ``GET  /apis/{kind}``                     list (``?namespace=`` optional)
- ``POST /apis/{kind}``                     create  → 409 already_exists
- ``GET  /apis/{kind}/{ns}/{name}``         get     → 404
- ``PUT  /apis/{kind}/{ns}/{name}``         CAS update → 409 conflict
- ``DELETE /apis/{kind}/{ns}/{name}``       delete  → 404
- ``GET  /rv``                              current resourceVersion
- ``GET  /watch?since=RV&timeout=S[&kind=&namespace=]``
  long-poll: events with resourceVersion > since, or ``[]`` on timeout.

Auth parity: the reference secures its endpoints with token authn/authz
filters (cmd/manager/main.go:126-138). Here a static bearer token guards
every route except /healthz; no token configured = open (dev mode),
mirroring ``--metrics-secure=false``.

Admission parity: LLMService writes are schema-validated server-side
(the CRD schema the reference API server enforces,
config/crd/bases/ai.ruijie.io_llmservices.yaml:45-60).

A copy of ``kubeinfer_tpu/controlplane/httpstore.py`` for the PyTorch
port. The wire format is the reference's: its ``ctl``, agents and
``RemoteStore`` talk to this server unchanged, and back. Its locks are
plain ``threading`` primitives: the reference's race-checker hooks are
no-ops outside an armed analysis run, and the race checker is not
ported.
"""

from __future__ import annotations

import collections
import json
import logging
import threading
import urllib.error
import urllib.parse
import urllib.request
from http.server import ThreadingHTTPServer
from typing import Any

from kubeinfer_tpu_torch.api.types import LLMService, ValidationError
from kubeinfer_tpu_torch.controlplane.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    Store,
    WatchEvent,
)
from kubeinfer_tpu_torch.resilience import (
    CircuitBreaker,
    RetryPolicy,
    connect_failure,
    transient_http,
)
from kubeinfer_tpu_torch.resilience import faultpoints
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.utils.httpbase import (
    BaseEndpointHandler,
    client_ssl_context,
    token_matches,
    traceparent_header,
    wrap_server_tls,
)

log = logging.getLogger(__name__)

_SERVER_TRACER = tracing.get_tracer("store")
_CLIENT_TRACER = tracing.get_tracer("store-client")

EVENT_LOG_SIZE = 65536  # ring of recent events served to long-pollers


def load_token(path: str) -> str:
    """Read a bearer token from a file (one copy for manager/agent/ctl)."""
    with open(path, "r", encoding="utf-8") as f:
        return f.read().strip()


class StoreServer:
    """Serves a Store over HTTP and republishes its watch stream.

    ``solve_handler`` (optional) exposes the scheduler as an RPC:
    ``POST /solve`` with a JSON problem → assignment (SURVEY.md §7 step
    3's solve-service boundary; the in-process dispatch the manager's
    own reconciler uses stays the fast path — this endpoint is for
    EXTERNAL controllers that want placements without embedding JAX).
    """

    def __init__(self, store: Store, host: str = "127.0.0.1", port: int = 0,
                 token: str = "", solve_handler=None,
                 tls_cert: str = "", tls_key: str = "") -> None:
        self._store = store
        self._token = token
        self._tls = bool(tls_cert)
        self._solve_handler = solve_handler
        # Event ring: long-pollers replay from here by resourceVersion.
        self._events: collections.deque[WatchEvent] = collections.deque(
            maxlen=EVENT_LOG_SIZE
        )
        self._events_cond = threading.Condition()
        self._watch = store.watch()
        self._pump = threading.Thread(
            target=self._pump_events, daemon=True, name="store-event-pump"
        )

        server = self

        class Handler(BaseEndpointHandler):
            def _send(self, code: int, body: dict | list) -> None:
                self.respond(code, "application/json", json.dumps(body))

            def _authed(self) -> bool:
                if not server._token:
                    return True
                got = self.headers.get("Authorization", "")
                return token_matches(got, server._token)

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _drop_body(self) -> None:
                self.drop_body()

            def _route(self, method: str) -> None:
                parsed = urllib.parse.urlparse(self.path)
                # unquote AFTER splitting: %2F inside a name must not
                # become a path separator
                parts = [
                    urllib.parse.unquote(p)
                    for p in parsed.path.split("/") if p
                ]
                q = urllib.parse.parse_qs(parsed.query)
                if parts == ["healthz"]:
                    self._drop_body()
                    self._send(200, {"status": "ok"})
                    return
                if not self._authed():
                    self._drop_body()
                    self._send(401, {"error": "unauthorized"})
                    return
                if parts == ["debug", "spans"] and method == "GET":
                    # recorded spans as Chrome trace-event JSON (open in
                    # Perfetto; docs/OBSERVABILITY.md). Authenticated:
                    # traces carry request paths and object names.
                    self._drop_body()
                    tid = q.get("trace_id", [None])[0]
                    self._send(200, tracing.RECORDER.to_chrome_trace(tid))
                    return
                try:
                    if parts == ["rv"] and method == "GET":
                        self._send(200, {"resourceVersion": server._store._rv})
                    elif parts == ["watch"] and method == "GET":
                        since = int(q.get("since", ["0"])[0])
                        timeout = min(float(q.get("timeout", ["30"])[0]), 300.0)
                        kind = q.get("kind", [None])[0]
                        ns = q.get("namespace", [None])[0]
                        evs, rv, store_rv, oldest = server._poll_events(
                            since, timeout, kind, ns
                        )
                        self._send(200, {
                            "resourceVersion": rv,
                            # the store's ACTUAL counter, unclamped by
                            # `since` (the rv above is a watch cursor,
                            # floored at the caller's position): a
                            # follower compares this against its local
                            # cursor to detect a primary whose history
                            # is BEHIND it (restart with fresh state)
                            "storeRv": store_rv,
                            # earliest rv still in the event ring (0 =
                            # empty): a follower whose `since` predates
                            # it cannot prove continuity and must full-
                            # resync via /dump
                            "oldestEvent": oldest,
                            "events": [
                                {
                                    "type": e.type, "kind": e.kind,
                                    "namespace": e.namespace, "name": e.name,
                                    "object": e.object,
                                    "resourceVersion": e.resource_version,
                                }
                                for e in evs
                            ],
                        })
                    elif parts == ["dump"] and method == "GET":
                        rv, objects = server._store.dump()
                        self._send(200, {
                            "resourceVersion": rv, "objects": objects,
                        })
                    elif parts == ["solve"] and method == "POST":
                        if server._solve_handler is None:
                            self._drop_body()
                            self._send(404, {"error": "no solver attached"})
                        else:
                            self._send(
                                200, server._solve_handler(self._body())
                            )
                    elif len(parts) == 2 and parts[0] == "apis":
                        kind = parts[1]
                        if method == "GET":
                            ns = q.get("namespace", [None])[0]
                            self._send(200, server._store.list(kind, ns))
                        elif method == "POST":
                            obj = server._admit(kind, self._body())
                            self._send(201, server._store.create(kind, obj))
                        else:
                            self._drop_body()
                            self._send(405, {"error": "method not allowed"})
                    elif len(parts) == 4 and parts[0] == "apis":
                        kind, ns, name = parts[1], parts[2], parts[3]
                        if method == "GET":
                            self._send(200, server._store.get(kind, name, ns))
                        elif method == "PUT":
                            obj = server._admit(kind, self._body())
                            self._send(200, server._store.update(kind, obj))
                        elif method == "DELETE":
                            server._store.delete(kind, name, ns)
                            self._send(200, {"status": "deleted"})
                        else:
                            self._drop_body()
                            self._send(405, {"error": "method not allowed"})
                    else:
                        self._drop_body()
                        self._send(404, {"error": "no such route"})
                except NotFoundError as e:
                    self._send(404, {"error": "not_found", "message": str(e)})
                except AlreadyExistsError as e:
                    self._send(409, {"error": "already_exists", "message": str(e)})
                except ConflictError as e:
                    self._send(409, {"error": "conflict", "message": str(e)})
                except (ValidationError, ValueError, json.JSONDecodeError) as e:
                    self._send(400, {"error": "invalid", "message": str(e)})
                except Exception as e:  # don't kill the connection thread
                    log.exception("httpstore: internal error")
                    self._send(500, {"error": "internal", "message": str(e)})

            def _traced(self, method: str) -> None:
                # server-side span per request, joined to the caller's
                # trace via the inbound traceparent header (path as an
                # attr, not the span name — names stay low-cardinality)
                with _SERVER_TRACER.span(
                    f"store {method}", parent=self.trace_context(),
                    path=self.path,
                ):
                    self._route(method)

            def do_GET(self):
                self._traced("GET")

            def do_POST(self):
                self._traced("POST")

            def do_PUT(self):
                self._traced("PUT")

            def do_DELETE(self):
                self._traced("DELETE")

        self._httpd = wrap_server_tls(
            ThreadingHTTPServer((host, port), Handler), tls_cert, tls_key
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="store-http"
        )

    # -- lifecycle --------------------------------------------------------

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        scheme = "https" if self._tls else "http"
        return f"{scheme}://{host}:{port}"

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "StoreServer":
        self._pump.start()
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._watch.close()
        with self._events_cond:
            self._events_cond.notify_all()

    def abort(self) -> None:
        """Release the bound socket and watch for a server that was
        constructed (socket bound) but never ``start()``ed — e.g. a
        promotion that lost the race to ``stop()``. ``shutdown()`` would
        deadlock here: BaseServer.shutdown blocks on serve_forever's
        exit handshake, and serve_forever never ran."""
        self._httpd.server_close()
        self._watch.close()
        with self._events_cond:
            self._events_cond.notify_all()

    # -- admission --------------------------------------------------------

    @staticmethod
    def _admit(kind: str, obj: dict[str, Any]) -> dict[str, Any]:
        """Server-side schema validation + defaulting for kinds with a
        schema (what the CRD schema + API-server defaulting do for the
        reference). The typed round-trip materializes defaulted fields
        (image, status skeleton) so consumers never see partial objects."""
        if kind == LLMService.KIND:
            svc = LLMService.from_dict(obj)
            svc.validate()
            return svc.to_dict()
        return obj

    # -- event plumbing ---------------------------------------------------

    def _pump_events(self) -> None:
        while True:
            ev = self._watch.next_event(timeout=1.0)
            if ev is None:
                if self._w_closed():
                    return
                continue
            with self._events_cond:
                self._events.append(ev)
                self._events_cond.notify_all()

    def _w_closed(self) -> bool:
        return self._watch._w.closed.is_set()

    def _poll_events(
        self, since: int, timeout: float, kind: str | None, ns: str | None
    ) -> tuple[list[WatchEvent], int, int, int]:
        """One long-poll page plus the gap markers, snapshotted together.

        Returns (events, watch-cursor rv, storeRv, oldestEvent). The
        markers are read under ``_events_cond`` IN THE SAME critical
        section that collects the events (ADVICE r5): an unlocked
        ``oldestEvent`` read racing the pump could otherwise pair a
        just-advanced ring head with an events page collected before the
        advance. (Direction analysis says that race only errs toward a
        spurious follower resync — oldest rises monotonically — but the
        snapshot makes the page self-consistent instead of leaning on
        that reasoning.) ``storeRv`` reads the store's counter, which may
        run AHEAD of the ring (writes land in the store before the pump
        republishes them); ahead is the safe direction for its one
        consumer — the behind-primary check in replica.py compares
        ``storeRv < follower cursor``.
        """
        def matching() -> list[WatchEvent]:
            # The ring is rv-ordered and pollers sit near the tip: scan
            # from the right and stop at the first already-seen event,
            # so each poll is O(new events), not O(ring).
            out: list[WatchEvent] = []
            for e in reversed(self._events):
                if e.resource_version <= since:
                    break
                if (kind is None or e.kind == kind) and (
                    ns is None or e.namespace == ns
                ):
                    out.append(e)
            out.reverse()
            return out

        with self._events_cond:
            evs = matching()
            if not evs and timeout > 0:
                self._events_cond.wait(timeout)
                evs = matching()
            rv = self._events[-1].resource_version if self._events else since
            oldest = self._events[0].resource_version if self._events else 0
            return evs, max(rv, since), self._store._rv, oldest


class RemoteStore:
    """Store-interface client over the wire protocol above.

    Drop-in for ``Store``: agents, controllers, and the CLI take whichever
    they are handed (the reference equivalently swaps in-cluster and
    kubeconfig clients, cmd/agent/main.go:56 vs _archive/election).

    Resilience: every request runs under a ``RetryPolicy``
    with idempotency-aware classification — GET/LIST/watch pages retry
    any transient transport failure (including a torn/corrupt response
    body); PUT/POST/DELETE retry ONLY connect-level failures, where the
    request provably never reached the server. A retried mutation that
    actually landed is caught by the protocol itself: creates surface
    AlreadyExistsError, CAS updates surface ConflictError, and every
    caller already treats both as "re-read and retry". A shared
    ``CircuitBreaker`` fails calls fast (``BreakerOpenError``, an
    OSError) during a sustained outage so high-frequency callers
    (heartbeat ticks) degrade in microseconds instead of burning a full
    retry schedule per tick.
    """

    # A store round-trip is local-network cheap; a short schedule rides
    # out a restart/failover without stretching anyone's failure
    # detector (deadline_s=0: the per-call cap is attempts × timeout,
    # and long-poll callers own their windows explicitly).
    _GET_POLICY = RetryPolicy(
        max_attempts=4, base_delay_s=0.05, max_delay_s=1.0, deadline_s=0,
        classify=transient_http,
    )
    _MUTATE_POLICY = RetryPolicy(
        max_attempts=4, base_delay_s=0.05, max_delay_s=1.0, deadline_s=0,
        classify=connect_failure,
    )
    # watch_page: NO retries and NO breaker accounting — the replica's
    # follow loop is itself a failure detector (failover_grace_s counts
    # consecutive failed polls), so a resilience layer underneath it
    # would stretch exactly the detection latency it calibrates.
    _RAW_POLICY = RetryPolicy(max_attempts=1, deadline_s=0)

    def __init__(self, base_url: str, token: str = "",
                 request_timeout_s: float = 35.0,
                 ca_file: str = "",
                 retry: bool = True,
                 breaker: CircuitBreaker | None = None) -> None:
        self.base_url = base_url.rstrip("/")
        self._token = token
        self._timeout = request_timeout_s
        # pinned CA bundle for https stores (None -> system default
        # verification for https URLs; ignored for http)
        self._ssl_ctx = client_ssl_context(ca_file)
        self._retry = retry
        # one breaker per client: all methods share the same TCP edge.
        # Tests/tools pass breaker=CircuitBreaker(failure_threshold=...)
        # to tune trip/reset; retry=False restores the seed's
        # single-attempt behavior (e.g. probes that time-box themselves).
        self._breaker = breaker if breaker is not None else CircuitBreaker(
            edge="store", failure_threshold=5, reset_timeout_s=1.0,
        )

    # -- plumbing ---------------------------------------------------------

    def _req(self, method: str, path: str, body: dict | None = None,
             timeout: float | None = None,
             policy: RetryPolicy | None = None,
             use_breaker: bool = True) -> Any:
        if policy is None:
            policy = self._GET_POLICY if method == "GET" else self._MUTATE_POLICY
        if not self._retry:
            policy = self._RAW_POLICY
        return policy.call(
            lambda: self._req_once(method, path, body, timeout),
            edge="store",
            breaker=self._breaker if (use_breaker and self._retry) else None,
        )

    def _req_once(self, method: str, path: str, body: dict | None,
                  timeout: float | None) -> Any:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        req.add_header("Content-Type", "application/json")
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        # one client span per ATTEMPT (this method is the retry unit):
        # retries show as sibling spans under the caller, and the
        # retry-policy events land on the enclosing caller span because
        # each attempt span has already ended when the policy fires them
        with _CLIENT_TRACER.span(
            f"store.{method}", path=path.split("?", 1)[0]
        ):
            tp = traceparent_header()
            if tp:
                req.add_header("traceparent", tp)
            faultpoints.fire("store.request", key=f"{method} {path}")
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout or self._timeout,
                    context=self._ssl_ctx,
                ) as resp:
                    raw = faultpoints.mangle(
                        "store.request", resp.read(), key=f"{method} {path}"
                    )
                    return json.loads(raw or b"null")
            except urllib.error.HTTPError as e:
                payload = {}
                try:
                    payload = json.loads(e.read() or b"{}")
                except json.JSONDecodeError:
                    pass
                msg = payload.get("message", str(e))
                code = payload.get("error", "")
                if e.code == 404:
                    raise NotFoundError(msg) from None
                if e.code == 409 and code == "already_exists":
                    raise AlreadyExistsError(msg) from None
                if e.code == 409:
                    raise ConflictError(msg) from None
                if e.code == 400:
                    raise ValidationError(msg) from None
                if e.code == 401:
                    raise PermissionError(f"unauthorized: {url}") from None
                raise

    def healthz(self) -> bool:
        try:
            # single attempt, no breaker: health probes are their own
            # retry loop, and a probe must see the edge's real state
            return self._req(
                "GET", "/healthz", policy=self._RAW_POLICY, use_breaker=False
            )["status"] == "ok"
        except Exception:
            return False

    # -- Store interface --------------------------------------------------

    @staticmethod
    def _seg(s: str) -> str:
        # names/namespaces/kinds are data, not path structure: a name like
        # "a/b" must travel as one segment ("a%2Fb")
        return urllib.parse.quote(s, safe="")

    def create(self, kind: str, obj: dict[str, Any]) -> dict[str, Any]:
        return self._req("POST", f"/apis/{self._seg(kind)}", obj)

    def get(self, kind: str, name: str, namespace: str = "default") -> dict[str, Any]:
        return self._req(
            "GET",
            f"/apis/{self._seg(kind)}/{self._seg(namespace)}/{self._seg(name)}",
        )

    def update(self, kind: str, obj: dict[str, Any]) -> dict[str, Any]:
        meta = obj.get("metadata", {})
        ns = meta.get("namespace", "default")
        name = meta.get("name", "")
        return self._req(
            "PUT",
            f"/apis/{self._seg(kind)}/{self._seg(ns)}/{self._seg(name)}",
            obj,
        )

    def delete(self, kind: str, name: str, namespace: str = "default") -> None:
        self._req(
            "DELETE",
            f"/apis/{self._seg(kind)}/{self._seg(namespace)}/{self._seg(name)}",
        )

    def list(self, kind: str, namespace: str | None = None) -> list[dict[str, Any]]:
        path = f"/apis/{self._seg(kind)}"
        if namespace is not None:
            path += f"?namespace={urllib.parse.quote(namespace)}"
        return self._req("GET", path)

    def watch(self, kind: str | None = None,
              namespace: str | None = None) -> "RemoteWatch":
        rv = self._req("GET", "/rv")["resourceVersion"]
        return RemoteWatch(self, kind, namespace, since=rv)

    # -- replication plumbing (controlplane/replica.py) -------------------

    def rv(self) -> int:
        return self._req("GET", "/rv")["resourceVersion"]

    def dump(self) -> tuple[int, list]:
        """Primary's full state for follower bootstrap/resync."""
        resp = self._req("GET", "/dump")
        return resp["resourceVersion"], resp["objects"]

    def watch_page(self, since: int, timeout: float) -> dict:
        """One raw long-poll page INCLUDING the gap marker
        (``oldestEvent``) — the follower needs it to decide between
        tailing and a full resync; RemoteWatch deliberately hides it."""
        return self._req(
            "GET",
            f"/watch?since={since}&timeout={timeout}",
            # small cushion over the server's long-poll window: the
            # client-side timeout is the blackhole-failure detector, so
            # it must not dwarf the replica's failover grace
            timeout=timeout + 2.0,
            # no retry/breaker: the replica's grace accounting counts
            # RAW poll failures (see _RAW_POLICY note above)
            policy=self._RAW_POLICY,
            use_breaker=False,
        )


class RemoteWatch:
    """Long-poll watch stream with the in-process ``Watch`` interface."""

    def __init__(self, store: RemoteStore, kind: str | None,
                 namespace: str | None, since: int) -> None:
        self._store = store
        self._kind = kind
        self._ns = namespace
        self._since = since
        self._pending: collections.deque[WatchEvent] = collections.deque()
        self._closed = False

    def _fetch(self, timeout: float) -> None:
        q = {"since": str(self._since), "timeout": f"{timeout:.3f}"}
        if self._kind is not None:
            q["kind"] = self._kind
        if self._ns is not None:
            q["namespace"] = self._ns
        path = "/watch?" + urllib.parse.urlencode(q)
        # network timeout must outlive the server-side long-poll window;
        # the deadline caps the whole retry schedule at roughly one
        # extra window so next_event() stays responsive to close()
        resp = self._store._req(
            "GET", path, timeout=timeout + 10.0,
            policy=RetryPolicy(
                max_attempts=3, base_delay_s=0.05, max_delay_s=0.5,
                deadline_s=timeout + 15.0, classify=transient_http,
            ),
        )
        self._since = max(self._since, resp["resourceVersion"])
        for e in resp["events"]:
            self._pending.append(
                WatchEvent(
                    type=e["type"], kind=e["kind"], namespace=e["namespace"],
                    name=e["name"], object=e["object"],
                    resource_version=e["resourceVersion"],
                )
            )
            self._since = max(self._since, e["resourceVersion"])

    def next_event(self, timeout: float | None = None) -> WatchEvent | None:
        if self._closed:
            return None
        if not self._pending:
            try:
                self._fetch(timeout if timeout is not None else 30.0)
            except (OSError, NotFoundError, json.JSONDecodeError):
                # transient (incl. a corrupt page that exhausted its
                # retries); caller's periodic tick covers it
                return None
        return self._pending.popleft() if self._pending else None

    def drain(self) -> list[WatchEvent]:
        if not self._closed and not self._pending:
            try:
                self._fetch(timeout=0.0)
            except (OSError, NotFoundError, json.JSONDecodeError):
                pass
        out = list(self._pending)
        self._pending.clear()
        return out

    def close(self) -> None:
        self._closed = True

    def __iter__(self):
        while not self._closed:
            ev = self.next_event(timeout=1.0)
            if ev is not None:
                yield ev
