"""The manager process: control-plane store + reconcile loop + endpoints.

Parity target: reference cmd/manager/main.go:56-204 — flag parsing, metrics
server with auth filtering (:126-138), health/ready probes (:190-197),
leader election option (:162-163), controller startup (:181-184), blocking
run (:200).

Deliberate differences:

- The reference manager is a *client* of the Kubernetes API server; this
  manager **hosts** the control plane itself (``StoreServer``) because the
  framework is standalone. ``--store-connect`` instead joins an external
  store (another manager's, or a test harness'), which is when
  ``--leader-elect`` matters — exactly the reference's HA topology.
- Metrics auth is a static bearer token (``--auth-token-file``); the
  reference's authn/authz delegates to the cluster
  (filters.WithAuthenticationAndAuthorization). Same posture: probes open,
  everything else tokened.

A copy of ``kubeinfer_tpu/manager/__init__.py`` for the PyTorch port.
It adds ``ManagerConfig.device``: every tick's placement and affinity
solves, and ``POST /solve``, run there. ``None`` is the CUDA card, and
the manager refuses to start without one; the CPU runs only where the
caller names it.
"""

from __future__ import annotations

import logging
import os
import secrets
import socket
import threading
from dataclasses import dataclass, field
from functools import partial
from http.server import ThreadingHTTPServer
from typing import Callable

from kubeinfer_tpu_torch import metrics
from kubeinfer_tpu_torch.controller.reconciler import Controller
from kubeinfer_tpu_torch.controlplane.httpstore import (
    RemoteStore,
    StoreServer,
    load_token,
)
from kubeinfer_tpu_torch.controlplane.store import Store
from kubeinfer_tpu_torch.coordination.lease import LeaseManager
from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.utils.clock import Clock, RealClock
from kubeinfer_tpu_torch.utils.httpbase import (
    BaseEndpointHandler,
    token_matches,
    wrap_server_tls,
)

__all__ = ["Manager", "ManagerConfig", "EndpointServer", "load_token"]

log = logging.getLogger(__name__)

MANAGER_LEASE = "kubeinfer-manager"  # leader-election lease name


class EndpointServer:
    """Tiny HTTP endpoint mux for probes and /metrics.

    Routes map path → callable returning (status, content_type, body).
    Paths in ``open_paths`` skip auth (probes must be reachable by the
    platform's health checker without credentials — main.go:190-197).
    """

    def __init__(self, host: str, port: int,
                 routes: dict[str, Callable[[], tuple[int, str, str]]],
                 token: str = "", open_paths: tuple[str, ...] = (),
                 tls_cert: str = "", tls_key: str = "") -> None:
        class Handler(BaseEndpointHandler):
            def do_GET(self):
                path = self.path.split("?", 1)[0]
                handler = routes.get(path)
                if handler is None:
                    self.respond(404, "text/plain", "not found\n")
                    return
                if token and path not in open_paths:
                    got = self.headers.get("Authorization", "")
                    if not token_matches(got, token):
                        self.respond(401, "text/plain", "unauthorized\n")
                        return
                try:
                    self.respond(*handler())
                except Exception as e:
                    log.exception("endpoint %s failed", path)
                    self.respond(500, "text/plain", f"error: {e}\n")

        self._httpd = wrap_server_tls(
            ThreadingHTTPServer((host, port), Handler), tls_cert, tls_key
        )
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"endpoints-{port}",
        )

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "EndpointServer":
        self._thread.start()
        return self

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


@dataclass
class ManagerConfig:
    """Flag surface (cmd/manager/main.go:65-86 analogue)."""

    store_bind_host: str = "127.0.0.1"
    store_bind_port: int = 18080
    metrics_bind_host: str = "127.0.0.1"
    metrics_bind_port: int = 18081  # ref --metrics-bind-address
    health_bind_host: str = "127.0.0.1"
    health_bind_port: int = 18082  # ref --health-probe-bind-address
    store_connect: str = ""  # join external store instead of hosting
    # durable state directory (journal + snapshots; store.py) — the etcd
    # role. Empty = in-memory (tests, ephemeral demos). Combined with
    # --store-connect it means REPLICA standby: tail the primary's
    # journal into this directory and promote (bind --store-bind-address
    # and serve the replica) when the primary dies — takeover WITH
    # state, the reference's replicated-etcd posture (replica.py).
    data_dir: str = ""
    # sustained primary-unreachable time before a replica standby
    # attempts promotion
    replica_failover_s: float = 5.0
    auth_token: str = ""
    tick_interval_s: float = 1.0
    node_ttl_s: float = 30.0
    leader_elect: bool = False  # ref --leader-elect
    # TLS for every served endpoint (store, metrics, health) and the
    # CA bundle for joining an https store — the reference's secured-
    # metrics posture (main.go:96-103,126-138) with the trust delegated
    # to these files instead of the cluster
    tls_cert_file: str = ""
    tls_key_file: str = ""
    store_ca_file: str = ""
    namespace: str = "default"
    identity: str = ""  # leader-election holder id (default: derived)
    # (duration_s, renew_s, retry_s) override for tests/demos;
    # None = reference timings (election.go:41-43)
    lease_timings: tuple[float, float, float] | None = None
    # where the tick's placement and affinity solves and POST /solve run:
    # None is the CUDA card (and raises without one); "cpu" only where a
    # caller asks for it, as the tests do
    device: str | None = None
    extra: dict = field(default_factory=dict)


class Manager:
    """Composable manager: store (hosted or joined), controller, endpoints."""

    def __init__(self, cfg: ManagerConfig, clock: Clock | None = None) -> None:
        self.cfg = cfg
        # before anything binds a port: no card, no manager
        self._device = resolve_device(cfg.device)
        self._clock = clock or RealClock()
        self._stop = threading.Event()
        self._ready = threading.Event()
        self._is_leader = threading.Event()
        self._threads: list[threading.Thread] = []
        # Serializes replica promotion against stop(): promotion runs on
        # the replica thread and publishes store/store_server/_local_store,
        # which stop() tears down — without mutual exclusion a stop racing
        # a promotion can leak a freshly bound StoreServer (socket held
        # forever) or close a store mid-publication. Reentrant because
        # promotion calls _start_election, which takes the lock itself so
        # the leader-elect boot path is equally guarded.
        self._promote_mu = threading.RLock()

        self._replica = None
        if cfg.store_connect:
            self.store_server = None
            self.store = RemoteStore(
                cfg.store_connect, token=cfg.auth_token,
                ca_file=cfg.store_ca_file,
            )
            if cfg.data_dir:
                from kubeinfer_tpu_torch.controlplane.replica import StoreReplica

                # request timeout derives from the grace: an in-flight
                # call is the blackhole-failure detector, so it must not
                # outlast the promotion deadline it feeds
                self._replica = StoreReplica(
                    RemoteStore(
                        cfg.store_connect, token=cfg.auth_token,
                        ca_file=cfg.store_ca_file,
                        request_timeout_s=max(
                            2.0, min(10.0, cfg.replica_failover_s)
                        ),
                    ),
                    data_dir=cfg.data_dir,
                    failover_grace_s=cfg.replica_failover_s,
                )
        else:
            self._local_store = Store(data_dir=cfg.data_dir or None)
            self.store_server = self._host_store_server(self._local_store)
            # The in-process controller bypasses HTTP (same truth, no hop).
            self.store = self._local_store

        self.controller = self._make_controller()
        self._lease: LeaseManager | None = None

        health_routes = {
            "/healthz": lambda: (200, "text/plain", "ok\n"),
            "/readyz": self._readyz,
        }
        if self._replica is not None:
            # standby observability: a replica is never /readyz (it does
            # not reconcile) but operators and the e2e need to know when
            # its journal tail is live before trusting a failover
            health_routes["/replicaz"] = lambda: (
                # promoted replicas stop tailing (they ARE the primary
                # now) — keep reporting 200 or the route reads as a
                # replica that lost its journal tail
                (200, "text/plain", "promoted\n")
                if self._replica.promoted.is_set()
                else (200, "text/plain", "synced\n")
                if self._replica.synced
                else (503, "text/plain", "syncing\n")
            )
        self.health_server = EndpointServer(
            cfg.health_bind_host, cfg.health_bind_port,
            routes=health_routes,
            tls_cert=cfg.tls_cert_file, tls_key=cfg.tls_key_file,
        )
        self.metrics_server = EndpointServer(
            cfg.metrics_bind_host, cfg.metrics_bind_port,
            routes={
                "/metrics": lambda: (
                    200, "text/plain; version=0.0.4",
                    metrics.REGISTRY.render(),
                ),
                "/healthz": lambda: (200, "text/plain", "ok\n"),
            },
            token=cfg.auth_token,
            open_paths=("/healthz",),
            tls_cert=cfg.tls_cert_file, tls_key=cfg.tls_key_file,
        )

    def _host_store_server(self, store: Store) -> StoreServer:
        """The hosted-store wiring, shared by boot-time primaries and
        replica promotion — one home so a promoted replica can never
        serve a differently-configured store than a boot primary."""
        from kubeinfer_tpu_torch.scheduler.backends import solve_service_handler

        cfg = self.cfg
        return StoreServer(
            store, cfg.store_bind_host, cfg.store_bind_port,
            token=cfg.auth_token,
            # POST /solve: the scheduler as an RPC for external
            # controllers (SURVEY §7 step 3 boundary)
            solve_handler=partial(solve_service_handler, device=self._device),
            tls_cert=cfg.tls_cert_file, tls_key=cfg.tls_key_file,
        )

    def _make_controller(self) -> Controller:
        return Controller(
            self.store, clock=self._clock, node_ttl_s=self.cfg.node_ttl_s,
            device=self._device,
        )

    # -- probes -----------------------------------------------------------

    def _readyz(self) -> tuple[int, str, str]:
        if self._ready.is_set():
            return 200, "text/plain", "ok\n"
        return 503, "text/plain", "not ready\n"

    @property
    def store_address(self) -> str:
        if self.store_server is not None:
            return self.store_server.address
        return self.cfg.store_connect

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Manager":
        if self.store_server is not None:
            self.store_server.start()
            log.info("store listening on %s", self.store_server.address)
        self.health_server.start()
        self.metrics_server.start()
        log.info(
            "probes on :%d, metrics on :%d%s",
            self.health_server.port, self.metrics_server.port,
            " (token auth)" if self.cfg.auth_token else " (NO AUTH — dev mode)",
        )
        if not self.cfg.auth_token:
            log.warning(
                "metrics/store endpoints are UNAUTHENTICATED; pass "
                "--auth-token-file for the reference's secured posture"
            )

        if self._replica is not None:
            # Warm standby: replicate only. Election + reconcile start at
            # promotion — pre-promotion this process must never reconcile
            # (the primary leads by construction), and running the
            # election against the remote store would just leave a lease
            # manager pointed at a store that is about to die.
            self._replica.start(self._promote_replica)
            log.info(
                "replica standby: following %s into %s",
                self.cfg.store_connect, self.cfg.data_dir,
            )
            return self

        if self.cfg.leader_elect:
            self._start_election()
        else:
            self._is_leader.set()
            self._start_controller()
        return self

    def _start_election(self) -> None:
        # HA parity (main.go:162-163): reconcile only while holding the
        # manager lease; standby managers take over on expiry.
        timing_kw = {}
        if self.cfg.lease_timings is not None:
            d, rn, rt = self.cfg.lease_timings
            timing_kw = dict(
                duration_s=d, renew_interval_s=rn, retry_interval_s=rt
            )
        # Default identity must be unique across HOSTS AND PROCESSES
        # (two managers agreeing on an identity = both lead =
        # split-brain); hostname+pid+random nonce guarantees it the
        # way the reference's pod name does.
        identity = self.cfg.identity or (
            f"manager-{socket.gethostname()}-{os.getpid()}-"
            f"{secrets.token_hex(4)}"
        )
        # _lease is published under _promote_mu everywhere it is written
        # (_promote_replica swaps it during failover); the boot path must
        # hold the same lock or a stop() racing startup can observe a
        # half-published lease (found by analysis lock-discipline).
        with self._promote_mu:
            if self._stop.is_set():
                return
            self._lease = LeaseManager(
                self.store, self.cfg.namespace, MANAGER_LEASE,
                identity=identity, clock=self._clock, **timing_kw,
            )
            self._lease.start(self._on_elected, self._on_lost)

    def _promote_replica(self) -> bool:
        """Serve the replica on the store frontend address (called from
        the replica thread on sustained primary failure). The BIND is
        the promotion arbitration — the VIP role: losing it to a
        sibling standby returns False and the replica resumes
        following. On success the manager becomes a full primary:
        hosted store, election (the dead leader's replicated lease must
        TTL-expire before this manager wins — CAS continuity makes that
        steal sound), reconcile.

        Runs entirely under ``_promote_mu`` so stop() can't interleave
        with the bind/publish sequence. ``_stop`` is checked both before
        AND after the bind: stop() sets the flag without the lock (it
        must — taking it first would deadlock against this very method
        via the replica-thread join), so the flag can flip while we hold
        the mutex. A dying manager must release the frontend it just
        won, not half-promote."""
        with self._promote_mu:
            if self._stop.is_set():
                return False
            try:
                server = self._host_store_server(self._replica.store)
            except OSError as e:
                log.warning("promotion bind lost (%s); resuming follow", e)
                return False
            if self._stop.is_set():
                # bound but never started: abort(), not shutdown() —
                # shutdown would block on a serve_forever that never ran
                server.abort()
                return False
            prev_store = self.store
            # a never-promoted replica has no _local_store attribute at
            # all (only the self-hosting __init__ branch sets it); None
            # is a safe restore value because stop() gates the close on
            # store_server, which rollback also clears
            prev_local = getattr(self, "_local_store", None)
            prev_controller = self.controller
            started = False
            try:
                self.store_server = server.start()
                started = True
                self._local_store = self._replica.store
                self.store = self._local_store
                self.controller = self._make_controller()
                if self.cfg.leader_elect:
                    self._start_election()
                else:
                    self._is_leader.set()
                    self._start_controller()
            except Exception:
                log.exception(
                    "promotion failed after bind; releasing the frontend"
                )
                if started:
                    server.shutdown()
                else:
                    server.abort()
                # full rollback to follower state: every attribute the
                # try block may have published must revert, or a later
                # promotion attempt (and any reader meanwhile) sees a
                # half-promoted manager pointed at the local store with
                # a controller built against it
                self.store_server = None
                self.store = prev_store
                self._local_store = prev_local
                self.controller = prev_controller
                self._is_leader.clear()
                if self._lease is not None:
                    self._lease.stop()
                    self._lease = None
                return False
            log.warning(
                "promoted: serving replicated store on %s (rv continuity "
                "from the dead primary)", server.address,
            )
            return True

    def _on_elected(self) -> None:
        log.info("manager elected leader")
        self._is_leader.set()
        self._start_controller()

    def _on_lost(self) -> None:
        log.info("manager lost leadership; pausing reconcile")
        self._is_leader.clear()

    def _start_controller(self) -> None:
        t = threading.Thread(
            target=self._controller_loop, daemon=True, name="controller"
        )
        self._threads.append(t)
        t.start()

    def _controller_loop(self) -> None:
        # First tick marks readiness (the controller can serve its caches).
        try:
            self.controller.reconcile_once()
        except Exception:
            log.exception("initial reconcile failed")
        self._ready.set()

        stop_or_demoted = threading.Event()

        def relay():
            while not self._stop.is_set() and self._is_leader.is_set():
                if self._stop.wait(0.2):
                    break
            stop_or_demoted.set()

        relay_t = threading.Thread(target=relay, daemon=True)
        relay_t.start()
        self.controller.run(stop_or_demoted, self.cfg.tick_interval_s)

    def run_forever(self, stop: threading.Event | None = None) -> None:
        """Block until ``stop`` (or self.stop()) — mgr.Start parity."""
        ext = stop or threading.Event()
        while not self._stop.is_set() and not ext.is_set():
            ext.wait(0.5)
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        # Handshake with an in-flight promotion: after this acquire,
        # either the promotion published its server/lease/threads (torn
        # down below) or it observed _stop and unwound itself. _stop MUST
        # be set before acquiring and the lock released before the joins
        # below — _replica.stop() joins the replica thread, which may be
        # inside _promote_replica waiting for this same lock.
        with self._promote_mu:
            pass
        self._is_leader.clear()
        if self._lease is not None:
            self._lease.stop()
        if self._replica is not None:
            # a promoted replica's store is closed below via the hosted
            # store path; an unpromoted one closes its own journal
            self._replica.stop()
        for t in self._threads:
            t.join(timeout=10)
        self.health_server.shutdown()
        self.metrics_server.shutdown()
        if self.store_server is not None:
            self.store_server.shutdown()
            # hosted store: flush+close the durability journal (no-op
            # for in-memory stores)
            self._local_store.close()
