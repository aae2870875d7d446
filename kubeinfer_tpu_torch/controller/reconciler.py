"""Batched LLMService reconciler (PyTorch port).

A copy of ``kubeinfer_tpu/controller/reconciler.py``: the same desired
state, garbage collection, drift correction, policy groups, bindings and
status writes. The one difference is the device: ``Controller`` resolves
it once at construction (``device=None`` means the CUDA card and raises
without one) and hands it to every group's ``get_backend(policy, device)``
and to ``solved_affinity(..., device=device)``, so each tick's placement
and affinity solves run on the card unless the caller names the CPU.

Reference shape (llmservice_controller.go:66-174): fetch CR → build desired
Deployment → create if missing → copy ready count to status → update status.
Reference gaps fixed here, per SURVEY.md:

- **Batched, not per-CR**: one tick lists every service/workload/node and
  solves ALL pending replicas in one dense tensor (§3.2 "insertion point for
  the batched TPU solver"), instead of one API round-trip chain per CR.
- **Drift correction**: the reference admits it never updates an existing
  Deployment (llmservice_controller.go:99-100); here replica count, image
  and model drift are reconciled every tick.
- **Garbage collection**: workloads whose owner LLMService is gone are
  deleted (the reference leans on K8s ownerReferences; our store has no GC
  of its own).
- **Placement is explicit**: bindings come from the SchedulerBackend
  selected per-CR by ``spec.schedulerPolicy`` — the north-star scheduler the
  reference delegates to kube-scheduler.

Full re-solve each tick (BASELINE.json config 4): every replica — bound or
not — re-enters the solve; the move-hysteresis cost keeps placements stable
unless priority pressure genuinely displaces them. A replica whose node
assignment changes is reset to Starting (its agent restarts the runtime).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from kubeinfer_tpu_torch import metrics
from kubeinfer_tpu_torch.api.types import LLMService, SchedulerPolicy
from kubeinfer_tpu_torch.api.workload import NodeState, ReplicaSpec, Workload
from kubeinfer_tpu_torch.controlplane.store import (
    AlreadyExistsError,
    ConflictError,
    NotFoundError,
    Store,
)
from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.observability import tracing
from kubeinfer_tpu_torch.router import scoring
from kubeinfer_tpu_torch.scheduler import SolveRequest, get_backend
from kubeinfer_tpu_torch.solver.problem import GIB, MAX_MODELS
from kubeinfer_tpu_torch.utils.clock import Clock, RealClock

log = logging.getLogger(__name__)

_TRACER = tracing.get_tracer("controller")

CONTROLLER_NAME = "llmservice"  # reconcile_total{controller=...}
NODE_HEARTBEAT_TTL_S = 30.0  # nodes silent longer than this are unschedulable


@dataclass
class ReconcileResult:
    """Diagnostics for one batched tick."""

    services: int = 0
    nodes: int = 0
    workloads_created: int = 0
    workloads_deleted: int = 0
    replicas_total: int = 0
    replicas_placed: int = 0
    evacuations: int = 0
    solve_ms: dict[str, float] = field(default_factory=dict)
    duration_ms: float = 0.0


class Controller:
    """Batched reconciler over a control-plane store."""

    def __init__(
        self,
        store: Store,
        clock: Clock | None = None,
        node_ttl_s: float = NODE_HEARTBEAT_TTL_S,
        slo_burn_limit: float = 0.0,
        drainer: Callable[[NodeState], bool] | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self._store = store
        # resolved once: every solve of every tick runs on this device,
        # and a missing card fails here, not on the first tick
        self._device = resolve_device(device)
        self._clock = clock or RealClock()
        self._node_ttl = node_ttl_s
        # SLO-burn evacuation (live-session migration's third caller):
        # a node whose serving heartbeat reports slo_burn >= limit gets
        # its sessions drained OUT before the SLO is blown, not after.
        # The drainer is injected because the controller must not know
        # how to reach a serving plane (in deployment it POSTs
        # /admin/drain to the node's replica endpoint; in tests it's a
        # recording lambda); it returns True once the drain is accepted.
        # limit <= 0 or drainer None disables the pass.
        self._slo_burn_limit = float(slo_burn_limit)
        self._drainer = drainer
        # one drain request per burn episode: the node stays hot (and
        # possibly above the limit) for the whole drain, and hammering
        # /admin/drain each tick would reset wait_drained clocks. The
        # episode ends when the node's heartbeat stops reporting
        # draining AND its burn is back under the limit.
        self._evacuating: set[str] = set()

    # -- desired state (reference desiredDeployment, :182-313) ------------

    def _desired_workload(self, svc: LLMService) -> Workload:
        name = svc.metadata.name
        cache_group = f"{name}-cache"  # llmservice_controller.go:191
        w = Workload(
            owner=name,
            image=svc.spec.image,
            model_repo=svc.spec.model,
            model_path="/models",
            cache_group=cache_group,
            cache_shared=svc.spec.cache_strategy.value == "shared",
            gpu_per_replica=svc.spec.gpu_per_replica,
            gpu_memory_bytes=svc.spec.gpu_memory_bytes(),
            env={  # env contract parity (llmservice_controller.go:231-266)
                "POD_NAMESPACE": svc.metadata.namespace,
                "CONFIGMAP_NAME": cache_group,
                "MODEL_PATH": "/models",
                "MODEL_REPO": svc.spec.model,
                # engine selection (vllm = reference pass-through,
                # native = in-framework TPU engine; runtime.py from_env)
                "RUNTIME_KIND": svc.spec.runtime.value,
                **(
                    {"VLLM_MAX_MODEL_LEN": str(svc.spec.max_model_len)}
                    if svc.spec.max_model_len > 0
                    else {}
                ),
            },
            replicas=[ReplicaSpec(index=i) for i in range(svc.spec.replicas)],
        )
        w.metadata.name = name
        w.metadata.namespace = svc.metadata.namespace
        w.metadata.owner_references = [
            {"kind": LLMService.KIND, "name": name, "uid": svc.metadata.uid}
        ]
        return w

    def _reconcile_workload(
        self, svc: LLMService, existing: Workload | None, result: ReconcileResult
    ) -> Workload:
        """Create-if-missing + drift correction (count/image/model)."""
        if existing is None:
            desired = self._desired_workload(svc)
            try:
                stored = self._store.create(Workload.KIND, desired.to_dict())
            except AlreadyExistsError:
                stored = self._store.get(
                    Workload.KIND, svc.metadata.name, svc.metadata.namespace
                )
            else:
                result.workloads_created += 1
            return Workload.from_dict(stored)

        w = existing
        dirty = False
        if w.image != svc.spec.image or w.model_repo != svc.spec.model:
            w.image = svc.spec.image
            w.model_repo = svc.spec.model
            w.env["MODEL_REPO"] = svc.spec.model
            # New model/image invalidates running replicas: restart them.
            for r in w.replicas:
                r.phase = "Starting" if r.node else "Pending"
            dirty = True
        want = svc.spec.replicas
        if len(w.replicas) != want:
            if len(w.replicas) > want:
                w.replicas = w.replicas[:want]
            else:
                w.replicas.extend(
                    ReplicaSpec(index=i) for i in range(len(w.replicas), want)
                )
            dirty = True
        w.gpu_per_replica = svc.spec.gpu_per_replica
        w.gpu_memory_bytes = svc.spec.gpu_memory_bytes()
        if dirty:
            w = self._update_workload(w)
        return w

    def _update_workload(self, w: Workload) -> Workload:
        """CAS write with merge-and-retry (agents also write workloads).

        Merge semantics: the controller owns bindings and replica-set
        shape; the agents own runtime truth (phase/pod fields). Where our
        binding agrees with the fresh copy, adopt the agent's runtime
        fields — clobbering them with our pre-tick snapshot would un-Ready
        replicas that just came up. Agents patch continuously (role flips,
        readiness), so a single retry is not enough under churn.
        """
        last: Exception | None = None
        for _ in range(8):
            try:
                stored = self._store.update(Workload.KIND, w.to_dict())
                return Workload.from_dict(stored)
            except ConflictError as e:
                last = e
                fresh = Workload.from_dict(
                    self._store.get(
                        Workload.KIND, w.metadata.name, w.metadata.namespace
                    )
                )
                fresh_by_index = {r.index: r for r in fresh.replicas}
                for r in w.replicas:
                    fr = fresh_by_index.get(r.index)
                    if fr is not None and fr.node == r.node:
                        r.phase = fr.phase
                        r.pod_name = fr.pod_name
                        r.pod_ip = fr.pod_ip
                w.metadata.resource_version = fresh.metadata.resource_version
        assert last is not None
        raise last

    # -- batched solve -----------------------------------------------------

    def _schedulable_nodes(self, now: float) -> list[NodeState]:
        nodes = [
            NodeState.from_dict(d) for d in self._store.list(NodeState.KIND)
        ]
        return [
            n
            for n in nodes
            if n.ready
            and (n.heartbeat == 0.0 or now - n.heartbeat <= self._node_ttl)
        ]

    def _evacuate_burning(self, nodes: list[NodeState],
                          result: ReconcileResult) -> None:
        """One evacuation pass over the schedulable nodes: drain the
        serving plane of every node whose heartbeat reports an SLO
        burn rate at or over the limit. Draining is the migration
        entry point — the node's engine streams its live sessions'
        KV out and the router resumes them on colder replicas — so
        this pass converts 'about to blow the SLO' into a latency
        blip instead of a correctness event. Failures stay candidates
        next tick; the pass never raises into the solve."""
        if self._slo_burn_limit <= 0 or self._drainer is None:
            return
        for n in nodes:
            stats = n.serving_stats if isinstance(n.serving_stats, dict) else {}
            name = n.metadata.name
            burning = (
                float(stats.get("slo_burn") or 0.0) >= self._slo_burn_limit
            )
            if stats.get("draining"):
                continue  # drain in progress (ours or an operator's)
            if not burning:
                self._evacuating.discard(name)  # episode over
                continue
            if name in self._evacuating:
                continue  # requested; heartbeat hasn't confirmed yet
            try:
                ok = bool(self._drainer(n))
            except Exception:
                log.exception("evacuation drain of %s failed", name)
                ok = False
            if ok:
                self._evacuating.add(name)
                result.evacuations += 1
            metrics.evacuations_total.inc(
                name, "drained" if ok else "failed"
            )

    def _solve_batch(
        self,
        pairs: list[tuple[LLMService, Workload]],
        nodes: list[NodeState],
        result: ReconcileResult,
    ) -> None:
        """One dense solve per scheduler policy; bindings written in place."""
        if not nodes:
            for _, w in pairs:
                for r in w.replicas:
                    if r.node:
                        r.node = ""
                        r.phase = "Pending"
            return

        node_index = {n.metadata.name: i for i, n in enumerate(nodes)}
        model_table: dict[str, int] = {}

        def model_slot(name: str) -> int:
            if not name:
                return 0
            slot = model_table.get(name)
            if slot is None:
                if len(model_table) + 1 >= MAX_MODELS:
                    return 0
                slot = len(model_table) + 1
                model_table[name] = slot
            return slot

        # Node-side free capacity is threaded THROUGH the policy groups:
        # each group's solve sees what the previous groups left, or two
        # backends would double-book the same chips.
        n_gpu = np.array([n.gpu_free for n in nodes], np.float32)
        n_mem = np.array(
            [n.gpu_memory_free_bytes / GIB for n in nodes], np.float32
        )
        n_gpu_cap = np.array([n.gpu_capacity for n in nodes], np.float32)
        n_mem_cap = np.array([n.gpu_memory_bytes / GIB for n in nodes], np.float32)
        n_topo = np.array([n.topology[0] for n in nodes], np.int32)

        # Group replica rows by policy (one dense solve per backend).
        groups: dict[str, list[tuple[LLMService, Workload]]] = {}
        for svc, w in pairs:
            groups.setdefault(svc.spec.scheduler_policy.value, []).append((svc, w))

        # Highest-priority group solves first: capacity is threaded between
        # groups, so group order is the cross-policy preemption order.
        ordered = sorted(
            groups.items(),
            key=lambda kv: -max(svc.spec.priority for svc, _ in kv[1]),
        )
        for policy, members in ordered:
            rows: list[tuple[Workload, ReplicaSpec]] = []
            gpu, mem, prio, gang, model, cur = [], [], [], [], [], []
            for gi, (svc, w) in enumerate(members):
                slot = model_slot(w.model_repo)
                for r in w.replicas:
                    rows.append((w, r))
                    gpu.append(float(w.gpu_per_replica))
                    mem.append(w.gpu_memory_bytes / GIB)
                    prio.append(float(svc.spec.priority))
                    gang.append(gi if svc.spec.gang else -1)
                    model.append(slot)
                    cur.append(node_index.get(r.node, -1))
            if not rows:
                continue

            # Lookup-only (no registration): a cached model no job in this
            # batch references gives no affinity signal, and registering it
            # would burn table slots needed by later job models.
            #
            # Queue-pressure affinity (ROADMAP item 4, solver-routed):
            # placement and the fleet router optimize the same
            # objective — prefix/cache affinity minus queue pressure
            # (router/scoring.py). Formerly a binary gate ("affine
            # unless the queue is PRESSURE_AFFINITY_CUTOFF deep");
            # now each job row runs as a pseudo-request through the
            # SAME batched route solve the router uses
            # (solver/routing.solved_affinity), so the bitmap holds
            # real solved assignments: the cutoff becomes relative (a
            # drowning caching node keeps its pull against
            # alternatives within CUTOFF of its own pressure) and the
            # greedy feedback spreads pulls across caching nodes
            # instead of piling every job's affinity onto one.
            # Capacity/feasibility is untouched — a drowning node can
            # still be chosen when nothing else fits.
            base_cached = np.zeros((len(nodes), MAX_MODELS), np.uint8)
            for i, n in enumerate(nodes):
                for m in n.cached_models:
                    s = model_table.get(m)
                    if s:
                        base_cached[i, s] = 1
            from kubeinfer_tpu_torch.solver import routing as solver_routing

            cached = solver_routing.solved_affinity(
                np.array(model, np.int32),
                base_cached,
                np.array(
                    [scoring.queue_pressure(n.serving_stats)
                     for n in nodes], np.float32,
                ),
                np.array(
                    [float((n.serving_stats or {}).get("n_slots") or 1)
                     if isinstance(n.serving_stats, dict) else 1.0
                     for n in nodes], np.float32,
                ),
                alpha=scoring.ALPHA_QUEUE_BLOCKS,
                cutoff=scoring.PRESSURE_AFFINITY_CUTOFF,
                device=self._device,
            )

            req = SolveRequest(
                job_gpu=np.array(gpu, np.float32),
                job_mem_gib=np.array(mem, np.float32),
                job_priority=np.array(prio, np.float32),
                job_gang=np.array(gang, np.int32),
                job_model=np.array(model, np.int32),
                job_current_node=np.array(cur, np.int32),
                node_gpu_free=n_gpu,
                node_mem_free_gib=n_mem,
                node_gpu_capacity=n_gpu_cap,
                node_mem_capacity_gib=n_mem_cap,
                node_topology=n_topo,
                node_cached=cached,
            )
            with _TRACER.span("controller.solve", policy=policy,
                              jobs=len(rows), nodes=len(nodes)):
                res = get_backend(policy, self._device).solve(req)
            result.solve_ms[policy] = res.solve_ms
            result.replicas_total += len(rows)
            result.replicas_placed += res.placed
            metrics.solve_duration_seconds.observe(policy, res.solve_ms / 1e3)
            metrics.solve_placement_ratio.set(
                policy, res.placed / max(len(rows), 1)
            )
            metrics.solve_problem_size.set(policy, "jobs", len(rows))
            metrics.solve_problem_size.set(policy, "nodes", len(nodes))

            for (w, r), a in zip(rows, res.assignment):
                new_node = nodes[a].metadata.name if a >= 0 else ""
                if a >= 0:
                    n_gpu[a] -= w.gpu_per_replica
                    n_mem[a] -= w.gpu_memory_bytes / GIB
                if new_node != r.node:
                    r.node = new_node
                    r.phase = "Starting" if new_node else "Pending"
                    r.pod_name = ""
                    r.pod_ip = ""
                elif new_node and r.phase == "Pending":
                    r.phase = "Starting"

    # -- status (reference :148-164) --------------------------------------

    def _sync_status(self, svc: LLMService, w: Workload) -> None:
        from kubeinfer_tpu_torch.api.types import Condition

        ready = sum(1 for r in w.replicas if r.phase == "Ready")
        bound = sum(1 for r in w.replicas if r.node)
        svc.status.available_replicas = ready
        svc.status.placements = [r.node for r in w.replicas]
        if ready == len(w.replicas) and ready > 0:
            phase = "Running"
        elif ready > 0:
            phase = "Degraded"
        elif bound > 0:
            phase = "Scheduling"
        else:
            phase = "Pending"
        svc.status.phase = phase
        svc.status.set_condition(
            Condition(
                type="Available",
                status="True" if phase == "Running" else "False",
                reason=phase,
                message=f"{ready}/{len(w.replicas)} replicas ready",
                last_update_time=self._clock.now(),
            )
        )
        # Elected coordinator from the lease (status.CacheCoordinator parity)
        try:
            lease = self._store.get(
                "Lease", f"{w.cache_group}-lease", svc.metadata.namespace
            )
            svc.status.cache_coordinator = lease["spec"].get("holderIdentity", "")
        except NotFoundError:
            svc.status.cache_coordinator = ""

        metrics.llmservice_ready_replicas.set(
            svc.metadata.namespace, svc.metadata.name, ready
        )
        try:
            self._store.update(LLMService.KIND, svc.to_dict())
        except ConflictError:
            # Spec writer won the race; next tick re-syncs status.
            metrics.reconcile_total.inc(CONTROLLER_NAME, "conflict")

    # -- the tick ----------------------------------------------------------

    def reconcile_once(self) -> ReconcileResult:
        # one span per tick: store-client spans (lists, status writes)
        # and per-policy solve spans nest under it
        with _TRACER.span("controller.reconcile") as sp:
            result = self._reconcile_once()
            sp.set(services=result.services, nodes=result.nodes,
                   placed=result.replicas_placed)
            return result

    def _reconcile_once(self) -> ReconcileResult:
        t0 = time.perf_counter()
        result = ReconcileResult()
        now = self._clock.now()

        services = [
            LLMService.from_dict(d) for d in self._store.list(LLMService.KIND)
        ]
        workloads = {
            (d["metadata"]["namespace"], d["metadata"]["name"]): Workload.from_dict(d)
            for d in self._store.list(Workload.KIND)
        }
        result.services = len(services)

        # GC: workloads whose owner is gone (ownerReferences semantics).
        svc_keys = {(s.metadata.namespace, s.metadata.name) for s in services}
        for key, w in list(workloads.items()):
            if key not in svc_keys:
                try:
                    self._store.delete(Workload.KIND, w.metadata.name, w.metadata.namespace)
                    result.workloads_deleted += 1
                    metrics.llmservice_ready_replicas.delete(
                        w.metadata.namespace, w.metadata.name
                    )
                except NotFoundError:
                    pass
                del workloads[key]

        pairs: list[tuple[LLMService, Workload]] = []
        for svc in services:
            key = (svc.metadata.namespace, svc.metadata.name)
            w = self._reconcile_workload(svc, workloads.get(key), result)
            pairs.append((svc, w))

        nodes = self._schedulable_nodes(now)
        result.nodes = len(nodes)
        self._evacuate_burning(nodes, result)
        self._solve_batch(pairs, nodes, result)

        for svc, w in pairs:
            w = self._update_workload(w)
            self._sync_status(svc, w)

        metrics.llmservice_total.set(len(services))
        result.duration_ms = (time.perf_counter() - t0) * 1e3
        metrics.reconcile_total.inc(CONTROLLER_NAME, "success")
        metrics.reconcile_duration_seconds.observe(
            CONTROLLER_NAME, result.duration_ms / 1e3
        )
        return result

    # -- loop --------------------------------------------------------------

    def run(self, stop, tick_interval_s: float = 1.0) -> None:
        """Reconcile loop: immediate tick on watch events (the
        SetupWithManager For+Owns equivalent), periodic tick as fallback.
        ``stop`` is a threading.Event.

        After each tick, events the tick itself produced (workload/status
        writes) are drained so the controller doesn't wake on its own
        writes; an external write racing that drain is picked up by the
        next periodic tick at the latest.
        """
        watch = self._store.watch()
        try:
            while not stop.is_set():
                try:
                    self.reconcile_once()
                except Exception:
                    # A failed tick must not kill the control plane; the
                    # next tick re-lists everything from scratch.
                    log.exception("reconcile tick failed")
                    metrics.reconcile_total.inc(CONTROLLER_NAME, "error")
                watch.drain()
                ev = watch.next_event(timeout=tick_interval_s)
                if ev is not None:
                    watch.drain()  # coalesce: one tick serves a burst
        finally:
            watch.close()
