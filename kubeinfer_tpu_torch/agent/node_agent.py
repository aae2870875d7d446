"""Node agent (kubelet-equivalent) and replica agent (per-pod agent).

``ReplicaAgent`` is the parity port of the reference's per-pod agent binary
(cmd/agent/main.go:32-201): it joins the cache group's lease election and
flips between Coordinator and Follower roles; the coordinator endpoint is
resolved lease-holder → replica pod record, mirroring getCoordinatorIP's
HolderIdentity → Pod IP lookup (main.go:175-201). With
``cacheStrategy: none`` there is no election: every replica downloads from
the hub itself (the reference declares the field but never reads it —
SURVEY.md §0; this is its documented intent).

``NodeAgent`` has no reference counterpart — it covers the duties the
reference delegates to kubelet plus the north star's new requirement:
**report node-state vectors** (NodeState heartbeats with capacity /
free / cached-model data) that feed the solver's node tensor, and start/
stop ReplicaAgents for workload replicas the solver binds to its node.

Counterpart of ``kubeinfer_tpu/agent/node_agent.py`` over the port's
store and lease. The reference registers ``NodeAgent`` with its race
checker (``analysis.racecheck.guard``); the port has no ``analysis/``
and its locks are plain ``threading`` primitives, which is what the
reference's hook gives outside an armed analysis run.
"""

from __future__ import annotations

import json
import logging
import os
import pathlib
import threading
from typing import Callable

from kubeinfer_tpu_torch import metrics
from kubeinfer_tpu_torch.agent.coordinator import Coordinator, hub_download
from kubeinfer_tpu_torch.agent.follower import Follower
from kubeinfer_tpu_torch.agent.model_server import ensure_model_dir
from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig
from kubeinfer_tpu_torch.api.workload import NodeState, Workload
from kubeinfer_tpu_torch.controlplane.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    Store,
)
from kubeinfer_tpu_torch.coordination.lease import LeaseManager
from kubeinfer_tpu_torch.inference.kv_blocks import SUMMARY_FINGERPRINT_BUDGET
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.resilience import faultpoints
from kubeinfer_tpu_torch.utils.clock import Clock, RealClock

_TRACER = tracing.get_tracer("node-agent")

log = logging.getLogger(__name__)

# Store-edge failures a tick must survive: connection-level OSErrors
# (which includes urllib's URLError/HTTPError and the circuit breaker's
# fast-fail BreakerOpenError) and corrupt response payloads that
# exhausted the store client's own retries. Domain errors (NotFound,
# Conflict) are NOT here — they mean the store answered and the
# specific handler owns the semantics.
STORE_TRANSIENT = (OSError, json.JSONDecodeError)


def model_cache_dir(root: str, model_repo: str) -> str:
    """Node-local cache dir for a model; replicas of the same model on one
    node share it (that sharing IS the cache the reference builds)."""
    return str(pathlib.Path(root) / model_repo.replace("/", "--"))


def _clamp_serving_stats(serving: dict) -> dict:
    """Cap the heartbeat's servingStats payload.

    The engine's stats_summary already truncates its cache summary at
    kv_blocks.SUMMARY_FINGERPRINT_BUDGET, but the callback is
    injectable (tests, future runtimes) and every NodeState write lands
    in the store — a misbehaving callback must not turn the 1/s
    heartbeat into multi-megabyte store churn. The clamp re-truncates
    the fingerprint list in place-of (never mutating the caller's dict)
    and is deterministic: the list is already hottest-first ordered by
    the producer, so keeping a prefix keeps the hottest paths."""
    summary = serving.get("cache_summary")
    if not isinstance(summary, dict):
        return serving
    fps = summary.get("fingerprints")
    if not isinstance(fps, list) or len(fps) <= SUMMARY_FINGERPRINT_BUDGET:
        return serving
    out = dict(serving)
    out["cache_summary"] = dict(
        summary,
        fingerprints=fps[:SUMMARY_FINGERPRINT_BUDGET],
        truncated=True,
    )
    return out


class ReplicaAgent:
    """One workload replica's agent process."""

    def __init__(
        self,
        store: Store,
        workload_name: str,
        namespace: str,
        replica_index: int,
        node_name: str,
        model_root: str,
        clock: Clock | None = None,
        downloader: Callable[[str, str], None] = hub_download,
        runtime_config: RuntimeConfig | None = None,
        start_runtime: bool = False,
        lease_timings: tuple[float, float, float] | None = None,
    ) -> None:
        self._store = store
        self._workload = workload_name
        self._ns = namespace
        self._index = replica_index
        self._node = node_name
        self._model_root = model_root
        self._clock = clock or RealClock()
        self._downloader = downloader
        self._runtime_config = runtime_config
        self._start_runtime = start_runtime
        self._lease_timings = lease_timings
        # pod-name analogue; also the lease holder identity
        self.identity = f"{workload_name}-{replica_index}"
        self._lease: LeaseManager | None = None
        self._role_stop: threading.Event | None = None
        self._role_thread: threading.Thread | None = None
        self._supervisor: threading.Thread | None = None
        self._stopped = threading.Event()
        self.model_repo = ""
        self.image = ""
        self.cache_shared = False
        self.workload_env: dict[str, str] = {}

    # -- workload record I/O ------------------------------------------------

    def _read_workload(self) -> Workload:
        return Workload.from_dict(
            self._store.get(Workload.KIND, self._workload, self._ns)
        )

    def _patch_replica(self, phase: str | None = None, pod_ip: str | None = None) -> None:
        """Read-modify-write only this replica's runtime fields.

        Best-effort under a store outage: this runs on election-callback
        and role threads, so a transport failure that survived the store
        client's own retries is logged and dropped — the alternative
        kills the election loop, which is the reference's documented
        fragility (agent/__init__.py parity notes). A missed phase patch
        is corrected by the controller's drift pass / the next role flip.
        """
        for _ in range(5):
            try:
                w = self._read_workload()
            except NotFoundError:
                return
            except STORE_TRANSIENT as e:
                log.warning(
                    "%s: replica patch skipped (store: %s)", self.identity, e
                )
                return
            for r in w.replicas:
                if r.index == self._index:
                    if r.node != self._node:
                        return  # rebound elsewhere; not ours anymore
                    if phase is not None:
                        r.phase = phase
                    if pod_ip is not None:
                        r.pod_ip = pod_ip
                    r.pod_name = self.identity
                    break
            else:
                return
            try:
                self._store.update(Workload.KIND, w.to_dict())
                return
            except ConflictError:
                continue
            except STORE_TRANSIENT as e:
                log.warning(
                    "%s: replica patch dropped (store: %s)", self.identity, e
                )
                return
        log.warning("%s: replica patch kept conflicting", self.identity)

    def _resolve_coordinator(self) -> str:
        """Lease holder → that replica's published endpoint
        (getCoordinatorIP parity, cmd/agent/main.go:175-201)."""
        if self._lease is None:
            return ""
        holder = self._lease.get_holder()
        if not holder or holder == self.identity:
            return ""
        try:
            w = self._read_workload()
        except NotFoundError:
            return ""
        for r in w.replicas:
            if r.pod_name == holder and r.pod_ip:
                return r.pod_ip
        return ""

    # -- role management ----------------------------------------------------

    def _stop_role(self) -> None:
        if self._role_stop is not None:
            self._role_stop.set()
        if self._role_thread is not None:
            # Join must outlive the runtime stop escalation (SIGTERM grace
            # 10s + SIGKILL + wait 5s, runtime.py stop): an agent that
            # exits mid-escalation leaks the runtime subprocess.
            self._role_thread.join(timeout=20)
        self._role_stop = None
        self._role_thread = None

    def _spawn(self, target, name: str) -> threading.Event:
        stop = threading.Event()
        t = threading.Thread(target=target, args=(stop,), daemon=True, name=name)
        self._role_stop = stop
        self._role_thread = t
        t.start()
        return stop

    def _become_coordinator(self) -> None:
        if self._stopped.is_set():
            # A clean lease surrender during stop() fires role callbacks;
            # a dying agent must not spawn roles or patch the store.
            return
        metrics.coordinator_elections_total.inc(self._ns, self._lease_name())
        self._stop_role()
        self._patch_replica(phase="Starting")
        coord = Coordinator(
            model_repo=self.model_repo,
            model_path=model_cache_dir(self._model_root, self.model_repo),
            runtime_config=self._runtime_config,
            downloader=self._downloader,
            start_runtime=self._start_runtime,
        )

        def body(stop: threading.Event) -> None:
            try:
                coord.run_prepare(cancel=stop)
            except Exception:
                log.exception("%s: coordinator prepare failed", self.identity)
                # Release whatever run_prepare started (the model server may
                # already be serving when the runtime fails) or a successor
                # coordinator hits EADDRINUSE on a fixed serve port.
                coord.shutdown()
                # Same stale-phase hazard as the Ready patch below: a torn-
                # down role's late failure must not clobber the successor.
                if not stop.is_set():
                    self._patch_replica(phase="Failed")
                return
            if stop.is_set():
                # Role torn down mid-download (_stop_role's join timed out):
                # patching Ready now would overwrite the successor role's
                # Starting with a stale phase and a dead endpoint.
                coord.shutdown()
                return
            self._patch_replica(phase="Ready", pod_ip=coord.endpoint)
            stop.wait()
            coord.shutdown()

        self._spawn(body, f"coordinator-{self.identity}")

    def _become_follower(self) -> None:
        if self._stopped.is_set():
            return
        self._stop_role()
        self._patch_replica(phase="Starting")
        follower = Follower(
            coordinator_endpoint=self._resolve_coordinator,
            model_path=model_cache_dir(self._model_root, self.model_repo),
            runtime_config=self._runtime_config,
            start_runtime=self._start_runtime,
            transfer_ca_file=os.environ.get("TRANSFER_CA_FILE", ""),
        )

        def body(stop: threading.Event) -> None:
            # The coordinator may still be downloading from the hub for
            # minutes before it publishes an endpoint; keep retrying until
            # the role is torn down rather than failing the replica.
            while not stop.is_set():
                try:
                    follower.sync()
                    break
                except Exception as e:
                    log.warning("%s: follower sync not ready: %s", self.identity, e)
                    if stop.wait(1.0):
                        return
            if stop.is_set():
                return
            try:
                follower.start_serving(cancel=stop)
            except Exception:
                # runtime never became healthy: release it (same leak/
                # stale-phase hazards as the coordinator body handles)
                log.exception("%s: follower runtime failed", self.identity)
                follower.shutdown()
                if not stop.is_set():
                    self._patch_replica(phase="Failed")
                return
            if stop.is_set():
                # role torn down during the (possibly minutes-long) health
                # wait: a stale Ready here would clobber the successor
                follower.shutdown()
                return
            self._patch_replica(phase="Ready")
            stop.wait()
            follower.shutdown()

        self._spawn(body, f"follower-{self.identity}")

    def _become_solo(self) -> None:
        """cacheStrategy none: no election, direct hub download, no model
        server."""
        if self._stopped.is_set():
            return
        self._stop_role()
        self._patch_replica(phase="Starting")
        coord = Coordinator(
            model_repo=self.model_repo,
            model_path=model_cache_dir(self._model_root, self.model_repo),
            runtime_config=self._runtime_config,
            downloader=self._downloader,
            start_runtime=self._start_runtime,
            serve_model=False,
        )

        def body(stop: threading.Event) -> None:
            try:
                coord.run_prepare(cancel=stop)
            except Exception:
                log.exception("%s: model download failed", self.identity)
                coord.shutdown()
                if not stop.is_set():
                    self._patch_replica(phase="Failed")
                return
            if stop.is_set():
                # same stale-Ready guard as the coordinator body
                coord.shutdown()
                return
            self._patch_replica(phase="Ready")
            stop.wait()
            coord.shutdown()

        self._spawn(body, f"solo-{self.identity}")

    def _lease_name(self) -> str:
        # lease name derives from the cache group exactly like
        # cmd/agent/main.go:72 derives it from CONFIGMAP_NAME
        return f"{self._cache_group}-lease"

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        w = self._read_workload()
        self.model_repo = w.model_repo
        self.image = w.image
        self.cache_shared = w.cache_shared
        self.workload_env = dict(w.env)
        self._cache_group = w.cache_group
        if self._runtime_config is None and self._start_runtime:
            # Build the runtime config from the workload's env contract
            # (the controller injects RUNTIME_KIND / VLLM_* /
            # MODEL_PATH exactly as the reference injects pod env,
            # llmservice_controller.go:231-266) layered over process env.
            import os

            from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig

            merged = {**os.environ, **w.env}
            # the runtime serves from this replica's node-local cache dir
            merged["MODEL_PATH"] = model_cache_dir(
                self._model_root, w.model_repo
            )
            self._runtime_config = RuntimeConfig.from_env(merged)
        if self.cache_shared:
            timing_kw = {}
            if self._lease_timings is not None:
                d, rn, rt = self._lease_timings
                timing_kw = dict(
                    duration_s=d, renew_interval_s=rn, retry_interval_s=rt
                )
            self._lease = LeaseManager(
                self._store,
                self._ns,
                self._lease_name(),
                self.identity,
                clock=self._clock,
                **timing_kw,
            )
            self._lease.start(self._become_coordinator, self._become_follower)
        else:
            self._become_solo()

    def stop(self) -> None:
        self._stopped.set()
        if self._lease is not None:
            self._lease.stop()
        self._stop_role()


class NodeAgent:
    """Per-node daemon: heartbeats NodeState, runs ReplicaAgents for
    replicas the solver binds to this node."""

    def __init__(
        self,
        store: Store,
        node_name: str,
        gpu_capacity: float,
        gpu_memory_bytes: int,
        model_root: str,
        topology: tuple[int, int] = (0, 0),
        clock: Clock | None = None,
        heartbeat_interval_s: float = 10.0,
        downloader: Callable[[str, str], None] = hub_download,
        start_runtimes: bool = False,
        lease_timings: tuple[float, float, float] | None = None,
        observe_memory=None,
        serving_stats=None,
    ) -> None:
        self._store = store
        self.node_name = node_name
        self._gpu_capacity = gpu_capacity
        self._mem_capacity = gpu_memory_bytes
        self._model_root = model_root
        self._topology = topology
        self._clock = clock or RealClock()
        self._interval = heartbeat_interval_s
        self._downloader = downloader
        self._start_runtimes = start_runtimes
        self._lease_timings = lease_timings
        self._agents: dict[tuple[str, str, int], ReplicaAgent] = {}
        # () -> (total_bytes, free_bytes) | None: live HBM observation
        # (probe.probe_accelerators-backed in production; injectable for
        # tests). None disables observation: heartbeats report full
        # capacity as before.
        self._observe_memory = observe_memory
        # () -> dict | None: serving-replica efficiency summary
        # (ContinuousEngine.stats_summary-backed when this node runs a
        # serving replica; injectable like observe_memory). Advertised
        # on the NodeState heartbeat so the control plane sees replica
        # load without scraping every pod's /metrics.
        self._serving_stats = serving_stats
        # per-replica HBM demand for replicas THIS agent runs — the
        # framework-owned share of observed usage (see heartbeat)
        self._replica_mem: dict[tuple[str, str, int], int] = {}
        # degraded-mode state: the last workload list the store
        # served, and when the outage started (None = store reachable).
        # During an outage ticks reconcile against this snapshot — bound
        # replicas keep running — and staleness is exported on /metrics.
        self._last_workloads: list[Workload] = []
        self._stale_since: float | None = None
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- node-state reporting ----------------------------------------------

    def _cached_models(self) -> list[str]:
        root = pathlib.Path(self._model_root)
        if not root.exists():
            return []
        out = []
        for d in sorted(root.iterdir()):
            if d.is_dir() and ensure_model_dir(str(d)):
                out.append(d.name.replace("--", "/"))
        return out

    def heartbeat(self) -> None:
        """Report node-state vectors for the solver.

        ``gpu_free`` is what the FRAMEWORK may allocate (capacity minus any
        external/system usage), NOT net of the framework's own bound
        replicas: the controller re-solves every placement from full
        capacity each tick. Subtracting our own replicas would double-count
        them and make incumbents look infeasible on their own node — the
        solve then evicts them, the next heartbeat frees the capacity, and
        placements oscillate.

        Transient store failures propagate to ``tick``, which degrades
        (stale heartbeat, cached bindings) instead of aborting the tick.

        With an HBM observer configured, EXTERNAL memory usage does reach
        the solver (a node half-eaten by a rogue
        process must attract proportionally fewer replicas): external =
        observed usage minus the framework-owned replicas' demand (which
        stays reported as free, preserving the anti-oscillation rule
        above), and the advertised free memory shrinks by exactly that.
        """
        with _TRACER.span("agent.heartbeat", node=self.node_name):
            self._heartbeat()

    def _heartbeat(self) -> None:
        faultpoints.fire("agent.heartbeat", key=self.node_name)
        mem_free = self._mem_capacity
        if self._observe_memory is not None:
            obs = self._observe_memory()
            if obs:
                total_obs, free_obs = obs
                framework = sum(self._replica_mem.values())
                external_used = max(0, (total_obs - free_obs) - framework)
                mem_free = max(0, self._mem_capacity - external_used)
        serving: dict = {}
        if self._serving_stats is not None:
            # a flaky stats callback must never cost the heartbeat —
            # liveness signal beats load telemetry
            try:
                serving = _clamp_serving_stats(self._serving_stats() or {})
            except Exception:  # noqa: BLE001
                log.exception("serving_stats callback failed; "
                              "heartbeating without stats")
        state = NodeState(
            gpu_capacity=self._gpu_capacity,
            gpu_free=self._gpu_capacity,
            gpu_memory_bytes=self._mem_capacity,
            gpu_memory_free_bytes=mem_free,
            topology=self._topology,
            cached_models=self._cached_models(),
            ready=True,
            heartbeat=self._clock.now(),
            serving_stats=serving,
        )
        state.metadata.name = self.node_name
        d = state.to_dict()
        try:
            cur = self._store.get(NodeState.KIND, self.node_name)
            d["metadata"]["resourceVersion"] = cur["metadata"]["resourceVersion"]
            self._store.update(NodeState.KIND, d)
        except NotFoundError:
            try:
                self._store.create(NodeState.KIND, d)
            except AlreadyExistsError:
                pass  # raced another registration; next beat updates
        except ConflictError:
            pass  # next beat wins

    # -- replica reconciliation (the kubelet duty) --------------------------

    def sync_replicas(self, workloads: list[Workload]) -> None:
        want: dict[tuple[str, str, int], Workload] = {}
        for w in workloads:
            for r in w.replicas:
                if r.node == self.node_name:
                    want[(w.metadata.namespace, w.metadata.name, r.index)] = w

        # Stop agents for replicas unbound/rebound elsewhere or spec drift.
        # Image is part of the restart condition: the reconciler resets bound
        # replicas to Starting on image change, and only a role restart
        # re-asserts Ready — without this, image-only updates leave the
        # replica Starting forever.
        for key, agent in list(self._agents.items()):
            w = want.get(key)
            if (
                w is None
                or agent.model_repo != w.model_repo
                or agent.image != w.image
                or agent.workload_env != w.env
            ):
                # env is part of the restart condition: RUNTIME_KIND /
                # VLLM_* changes (e.g. runtime: vllm -> native) only take
                # effect through a role restart, like image changes
                agent.stop()
                del self._agents[key]
                self._replica_mem.pop(key, None)

        for key, w in want.items():
            if key not in self._agents:
                ns, name, index = key
                agent = ReplicaAgent(
                    self._store,
                    workload_name=name,
                    namespace=ns,
                    replica_index=index,
                    node_name=self.node_name,
                    model_root=self._model_root,
                    clock=self._clock,
                    downloader=self._downloader,
                    start_runtime=self._start_runtimes,
                    lease_timings=self._lease_timings,
                )
                self._agents[key] = agent
                self._replica_mem[key] = w.gpu_memory_bytes
                try:
                    agent.start()
                except STORE_TRANSIENT as e:
                    # start() re-reads the workload record; a store blip
                    # here must not abort the whole sync pass. Drop the
                    # agent so the next tick re-creates it cleanly.
                    log.warning(
                        "%s: replica %s start deferred (store: %s)",
                        self.node_name, key, e,
                    )
                    agent.stop()
                    del self._agents[key]
                    self._replica_mem.pop(key, None)

    # -- loop ---------------------------------------------------------------

    def tick(self) -> None:
        """One reconcile+heartbeat pass, degrading under a store outage.

        A transient store failure (reset burst, 503 storm, breaker open)
        must not abort the tick: bound replicas keep running against the
        LAST-KNOWN workload list, and the outage is made observable —
        ``kubeinfer_agent_store_stale_seconds`` rises until the store
        answers again, ``kubeinfer_agent_degraded_ticks_total`` counts
        the ticks served from cache. The heartbeat is still attempted
        each tick (reads and writes can fail independently under partial
        faults) and its own transient failures are swallowed the same
        way. Recovery is automatic: the first successful list refreshes
        the cache and zeroes the staleness gauge.
        """
        # span per tick: store-client attempt spans and retry/fault
        # events from the resilience layer nest under it, so a chaos
        # run's degraded ticks are explainable from the trace alone
        with _TRACER.span("agent.tick", node=self.node_name) as sp:
            self._tick(sp)

    def _tick(self, sp: "tracing.Span") -> None:
        degraded = False
        try:
            workloads = [
                Workload.from_dict(d) for d in self._store.list(Workload.KIND)
            ]
            self._last_workloads = workloads
        except STORE_TRANSIENT as e:
            degraded = True
            workloads = self._last_workloads
            log.warning(
                "node agent %s: store unreachable (%s); reconciling "
                "against last-known bindings", self.node_name, e,
            )
        self.sync_replicas(workloads)
        try:
            self.heartbeat()
        except STORE_TRANSIENT:
            degraded = True
        if degraded:
            sp.event("degraded")
            metrics.agent_degraded_ticks_total.inc(self.node_name)
        if degraded and self._stale_since is None:
            self._stale_since = self._clock.now()
        elif not degraded:
            self._stale_since = None
        metrics.agent_store_stale_seconds.set(
            self.node_name,
            0.0 if self._stale_since is None
            else self._clock.now() - self._stale_since,
        )

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                log.exception("node agent %s tick failed", self.node_name)
            self._clock.wait(self._stop, self._interval)

    def start(self) -> threading.Thread:
        t = threading.Thread(
            target=self.run, daemon=True, name=f"node-agent-{self.node_name}"
        )
        self._thread = t
        t.start()
        return t

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
        for agent in self._agents.values():
            agent.stop()
        self._agents.clear()
