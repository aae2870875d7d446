"""SchedulerBackend interface + implementations (PyTorch port).

Counterpart of ``kubeinfer_tpu/scheduler/backends.py``. ``SolveRequest``
is the host-side problem (numpy SoA, unpadded) that the reconciler builds
per tick and the ``/solve`` RPC ships; ``SolveResult`` carries the
assignment plus timing diagnostics (p50 assign latency is the product's
headline metric). ``TorchBackend`` is the counterpart of ``JaxBackend``;
``get_backend(policy)`` maps the ``schedulerPolicy`` spec field to one.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kubeinfer_tpu_torch.api.types import SchedulerPolicy
from kubeinfer_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)


def request_has_incumbents(job_current_node: "np.ndarray | None") -> bool:
    """Whether a request carries incumbent placements: decides the
    solver's ``seeded`` flag (seeding + preemption repair)."""
    return job_current_node is not None and bool(
        np.any(np.asarray(job_current_node) >= 0)
    )


@dataclass
class SolveRequest:
    """One tick's batched placement problem (host-side, unpadded): one job
    row per replica; gang ids couple rows all-or-nothing; current_node
    (-1 = none) feeds move hysteresis; node_cached is a [N, M] bitmap."""

    job_gpu: np.ndarray
    job_mem_gib: np.ndarray
    node_gpu_free: np.ndarray
    node_mem_free_gib: np.ndarray
    job_priority: np.ndarray | None = None
    job_gang: np.ndarray | None = None
    job_model: np.ndarray | None = None
    job_current_node: np.ndarray | None = None
    node_gpu_capacity: np.ndarray | None = None
    node_mem_capacity_gib: np.ndarray | None = None
    node_topology: np.ndarray | None = None
    node_cached: np.ndarray | None = None

    @property
    def num_jobs(self) -> int:
        return int(self.job_gpu.shape[0])

    @property
    def num_nodes(self) -> int:
        return int(self.node_gpu_free.shape[0])


@dataclass
class SolveResult:
    """Assignment (node index per job, -1 unplaced) + diagnostics."""

    assignment: np.ndarray  # i32[J]
    placed: int
    solve_ms: float
    policy: str
    rounds: int = 0
    extras: dict[str, float] = field(default_factory=dict)


def _descending_stable_perm(pr: np.ndarray) -> np.ndarray:
    """Stable descending-priority permutation, identical to
    ``np.argsort(-pr, kind="stable")``; small integer priority ranges take
    numpy's radix path on uint8 keys (much cheaper at the 10k scale)."""
    if not np.isfinite(pr).all():
        return np.argsort(-pr, kind="stable")
    pi = pr.astype(np.int64)
    if (pi == pr).all():
        lo, hi = int(pi.min()), int(pi.max())
        if 1 < hi - lo + 1 <= 256:
            return np.argsort((hi - pi).astype(np.uint8), kind="stable")
    return np.argsort(-pr, kind="stable")


class SchedulerBackend:
    """Places a batch of replicas onto nodes."""

    name = "abstract"

    def solve(self, req: SolveRequest) -> SolveResult:
        raise NotImplementedError

    def warmup(self) -> None:
        """Pre-pay one-time costs (kernel builds, library loads) so the
        first production tick stays inside the latency budget."""


class NativeGreedyBackend(SchedulerBackend):
    """Serial first-fit-decreasing via the C++ native tier: the baseline
    the batched solve is measured against."""

    name = SchedulerPolicy.NATIVE_GREEDY.value

    def warmup(self) -> None:
        from kubeinfer_tpu_torch.native import load_native

        load_native()

    def solve(self, req: SolveRequest) -> SolveResult:
        from kubeinfer_tpu_torch.native import solve_greedy_native

        t0 = time.perf_counter()
        assignment, placed = solve_greedy_native(
            job_gpu=req.job_gpu,
            job_mem_gib=req.job_mem_gib,
            job_priority=req.job_priority,
            job_gang=req.job_gang,
            job_model=req.job_model,
            job_current_node=req.job_current_node,
            node_gpu_free=req.node_gpu_free,
            node_mem_free_gib=req.node_mem_free_gib,
            node_gpu_capacity=req.node_gpu_capacity,
            node_mem_capacity_gib=req.node_mem_capacity_gib,
            node_topology=req.node_topology,
            node_cached=req.node_cached,
        )
        ms = (time.perf_counter() - t0) * 1e3
        # the serial tier packs inside solve_ms: no separate encode step
        return SolveResult(
            assignment, placed, ms, self.name, extras={"encode_ms": 0.0}
        )


def auction_suitable(req: SolveRequest) -> bool:
    """Is this a one-replica-per-node instance the auction solver is built
    for? More jobs than nodes, or demands that could share a node, make
    the auction under-place."""
    if req.num_jobs > req.num_nodes:
        return False
    caps = (
        req.node_gpu_capacity
        if req.node_gpu_capacity is not None
        else req.node_gpu_free
    )
    max_cap = float(np.max(caps)) if caps.size else 0.0
    min_demand = float(np.min(req.job_gpu)) if req.job_gpu.size else 0.0
    return min_demand * 2.0 > max_cap


class TorchBackend(SchedulerBackend):
    """Batched solve on one torch device (the CUDA card unless the caller
    names another). Counterpart of ``JaxBackend``: priority sort, one
    packed buffer, one host-to-device copy, the solve, ONE readback, and
    the un-permute. A ``jax-auction`` request on a problem the auction
    cannot serve falls back to ``jax-greedy``, as in the reference."""

    def __init__(
        self,
        policy: SchedulerPolicy = SchedulerPolicy.JAX_GREEDY,
        device: str | torch.device | None = None,
    ):
        policy = SchedulerPolicy(policy)
        if policy not in (SchedulerPolicy.JAX_GREEDY, SchedulerPolicy.JAX_AUCTION):
            raise ValueError(f"not a batched policy: {policy}")
        self._policy = policy
        self.name = policy.value
        self.device = resolve_device(device)

    def warmup(self, num_jobs: int = 1024, num_nodes: int = 128) -> None:
        gpu, mem = 1.0, 1.0
        if self._policy is SchedulerPolicy.JAX_AUCTION:
            # a request the auction accepts (whole-node demands, jobs <=
            # nodes): a shared-node one would fall back to greedy, and the
            # first production auction solve would pay the auction
            # kernel's build inside a tick
            num_jobs, gpu, mem = min(num_jobs, num_nodes), 8.0, 64.0
        self.solve(
            SolveRequest(
                job_gpu=np.full(num_jobs, gpu, np.float32),
                job_mem_gib=np.full(num_jobs, mem, np.float32),
                node_gpu_free=np.full(num_nodes, 8.0, np.float32),
                node_mem_free_gib=np.full(num_nodes, 64.0, np.float32),
            )
        )

    def solve(self, req: SolveRequest) -> SolveResult:
        from kubeinfer_tpu_torch.solver.core import solve
        from kubeinfer_tpu_torch.solver.problem import (
            pack_problem_arrays,
            unpack_problem,
        )

        policy = self._policy.value
        fellback = False
        if (
            self._policy is SchedulerPolicy.JAX_AUCTION
            and not auction_suitable(req)
        ):
            from kubeinfer_tpu_torch import metrics

            metrics.auction_fallback_total.inc()
            log.warning(
                "jax-auction requested for a non-whole-node problem "
                "(%d jobs, %d nodes): falling back to jax-greedy to avoid "
                "under-placement",
                req.num_jobs, req.num_nodes,
            )
            policy = SchedulerPolicy.JAX_GREEDY.value
            fellback = True

        t0 = time.perf_counter()
        # Priority-sort the job axis (stable, descending): the mega loop's
        # windows are contiguous slices of it, so the sort is what makes
        # earlier windows hold the higher priorities. Undone on the way out.
        perm = None
        if req.job_priority is not None and req.num_jobs > 1:
            pr = np.asarray(req.job_priority)
            if np.any(pr[1:] > pr[:-1]):
                perm = _descending_stable_perm(pr)
        buf, _, _, J, N = pack_problem_arrays(
            job_gpu=req.job_gpu,
            job_mem_gib=req.job_mem_gib,
            job_priority=req.job_priority,
            job_gang=req.job_gang,
            job_model=req.job_model,
            job_current_node=req.job_current_node,
            node_gpu_free=req.node_gpu_free,
            node_mem_free_gib=req.node_mem_free_gib,
            node_gpu_capacity=req.node_gpu_capacity,
            node_mem_capacity_gib=req.node_mem_capacity_gib,
            node_topology=req.node_topology,
            node_cached=req.node_cached,
            job_perm=perm,
        )
        t_encode = time.perf_counter()
        seeded = request_has_incumbents(req.job_current_node)
        out = solve(
            unpack_problem(buf, J, N, self.device), policy=policy,
            seeded=seeded, device=self.device,
        )
        # ONE readback for everything the caller needs
        host = torch.cat([out.node, out.rounds.view(1)]).cpu().numpy()
        node_host, rounds_host = host[:-1], int(host[-1])
        if perm is None:
            assignment = np.asarray(node_host[: req.num_jobs], np.int32)
        else:
            assignment = np.empty(req.num_jobs, np.int32)
            assignment[perm] = node_host[: req.num_jobs]
        placed = int((assignment >= 0).sum())
        t1 = time.perf_counter()
        extras = {"encode_ms": (t_encode - t0) * 1e3}
        if fellback:
            extras["auction_fallback"] = 1.0
        return SolveResult(
            assignment, placed, (t1 - t0) * 1e3, policy,
            rounds=rounds_host, extras=extras,
        )


def solve_service_handler(
    body: dict, device: str | torch.device | None = None
) -> dict:
    """JSON solve RPC (the ``/solve`` endpoint's business logic).

    Request: ``{"policy": "...", "jobs": {gpu, memGib, priority?, gang?,
    model?, currentNode?}, "nodes": {gpuFree, memFreeGib, gpuCapacity?,
    memCapacityGib?, topology?}}`` — arrays as JSON lists. Response:
    assignment + diagnostics."""
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    jobs = body.get("jobs") or {}
    nodes = body.get("nodes") or {}
    if not isinstance(jobs, dict) or not isinstance(nodes, dict):
        raise ValueError("jobs and nodes must be JSON objects")
    if "gpu" not in jobs or "gpuFree" not in nodes:
        raise ValueError("body needs jobs.gpu and nodes.gpuFree arrays")

    def arr(v, dtype, default=None):
        if v is None:
            return default
        return np.asarray(v, dtype)

    J, N = len(jobs["gpu"]), len(nodes["gpuFree"])
    req = SolveRequest(
        job_gpu=np.asarray(jobs["gpu"], np.float32),
        job_mem_gib=arr(
            jobs.get("memGib"), np.float32, np.zeros(J, np.float32)
        ),
        job_priority=arr(jobs.get("priority"), np.float32),
        job_gang=arr(jobs.get("gang"), np.int32),
        job_model=arr(jobs.get("model"), np.int32),
        job_current_node=arr(jobs.get("currentNode"), np.int32),
        node_gpu_free=np.asarray(nodes["gpuFree"], np.float32),
        node_mem_free_gib=arr(
            nodes.get("memFreeGib"), np.float32, np.zeros(N, np.float32)
        ),
        node_gpu_capacity=arr(nodes.get("gpuCapacity"), np.float32),
        node_mem_capacity_gib=arr(nodes.get("memCapacityGib"), np.float32),
        node_topology=arr(nodes.get("topology"), np.int32),
    )
    res = get_backend(body.get("policy", "jax-greedy"), device).solve(req)
    return {
        "assignment": res.assignment.tolist(),
        "placed": int(res.placed),
        "solveMs": round(res.solve_ms, 3),
        "policy": res.policy,
        "rounds": res.rounds,
    }


_BACKENDS: dict[tuple[str, str], SchedulerBackend] = {}


def get_backend(
    policy: str | SchedulerPolicy,
    device: str | torch.device | None = None,
) -> SchedulerBackend:
    """Backend for a schedulerPolicy value on a device (the CUDA card by
    default); instances are cached (built kernels and library handles
    live on them)."""
    policy = SchedulerPolicy(policy)
    if policy is SchedulerPolicy.NATIVE_GREEDY:
        cache_key = (policy.value, "host")
    else:
        cache_key = (policy.value, str(resolve_device(device)))
    backend = _BACKENDS.get(cache_key)
    if backend is None:
        if policy is SchedulerPolicy.NATIVE_GREEDY:
            backend = NativeGreedyBackend()
        else:
            backend = TorchBackend(policy, device)
        _BACKENDS[cache_key] = backend
    return backend
