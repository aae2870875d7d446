"""Workload and Node resource types.

The reference reconciler emits a Kubernetes ``Deployment`` and lets
kube-scheduler place the pods (internal/controller/llmservice_controller.go:96,
182-313). In kubeinfer_tpu the reconciler emits a ``Workload`` whose replicas
carry explicit **bindings** produced by the solver, and agents report ``Node``
objects with the capacity/allocatable/topology vectors the solver consumes
(the "node-state vectors" of BASELINE.json's north star — a duty the
reference agent does not have).

A copy of ``kubeinfer_tpu/api/workload.py`` for the PyTorch port. The
dict form is the reference's, key for key: the two stores read each
other's objects.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any

from kubeinfer_tpu_torch.api.types import ObjectMeta


@dataclass
class ReplicaSpec:
    """One replica of a Workload with its solver-produced binding."""

    index: int
    node: str = ""  # "" = unbound (solver couldn't place it yet)
    phase: str = "Pending"  # Pending | Starting | Ready | Failed
    pod_name: str = ""
    pod_ip: str = ""

    def to_dict(self) -> dict[str, Any]:
        return {
            "index": self.index,
            "node": self.node,
            "phase": self.phase,
            "podName": self.pod_name,
            "podIP": self.pod_ip,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ReplicaSpec":
        return cls(
            index=int(d.get("index", 0)),
            node=d.get("node", ""),
            phase=d.get("phase", "Pending"),
            pod_name=d.get("podName", ""),
            pod_ip=d.get("podIP", ""),
        )


@dataclass
class Workload:
    """Deployment-equivalent emitted by the reconciler.

    Environment contract parity: the reference injects POD_NAME/POD_NAMESPACE
    (Downward API), CONFIGMAP_NAME=<cr>-cache, MODEL_PATH=/models, MODEL_REPO
    into agent pods (llmservice_controller.go:231-266) and exposes ports 8000
    (inference) + 8080 (model server) (269-280). ``env`` carries the same
    contract for our agents; the lease name is derived from ``cache_group``
    exactly as the reference derives it from CONFIGMAP_NAME
    (cmd/agent/main.go:72).
    """

    KIND = "Workload"
    API_VERSION = "ai.kubeinfer-tpu.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    owner: str = ""  # name of the owning LLMService
    image: str = ""
    model_repo: str = ""
    model_path: str = "/models"
    cache_group: str = ""  # "<cr>-cache"; lease name = cache_group + "-lease"
    cache_shared: bool = False
    gpu_per_replica: int = 0
    gpu_memory_bytes: int = 0
    env: dict[str, str] = field(default_factory=dict)
    inference_port: int = 8000
    model_server_port: int = 8080
    replicas: list[ReplicaSpec] = field(default_factory=list)
    ready_replicas: int = 0

    def deepcopy(self) -> "Workload":
        return copy.deepcopy(self)

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": self.API_VERSION,
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "owner": self.owner,
            "image": self.image,
            "modelRepo": self.model_repo,
            "modelPath": self.model_path,
            "cacheGroup": self.cache_group,
            "cacheShared": self.cache_shared,
            "gpuPerReplica": self.gpu_per_replica,
            "gpuMemoryBytes": self.gpu_memory_bytes,
            "env": dict(self.env),
            "inferencePort": self.inference_port,
            "modelServerPort": self.model_server_port,
            "replicas": [r.to_dict() for r in self.replicas],
            "readyReplicas": self.ready_replicas,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Workload":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            owner=d.get("owner", ""),
            image=d.get("image", ""),
            model_repo=d.get("modelRepo", ""),
            model_path=d.get("modelPath", "/models"),
            cache_group=d.get("cacheGroup", ""),
            cache_shared=bool(d.get("cacheShared", False)),
            gpu_per_replica=int(d.get("gpuPerReplica", 0)),
            gpu_memory_bytes=int(d.get("gpuMemoryBytes", 0)),
            env=dict(d.get("env") or {}),
            inference_port=int(d.get("inferencePort", 8000)),
            model_server_port=int(d.get("modelServerPort", 8080)),
            replicas=[ReplicaSpec.from_dict(r) for r in (d.get("replicas") or [])],
            ready_replicas=int(d.get("readyReplicas", 0)),
        )


@dataclass
class NodeState:
    """Node capacity/allocatable vector reported by the node's agent.

    These are the per-node features the solver packs into its node tensor
    (SURVEY.md §7 step 1): accelerator counts/memory, topology coordinates
    for affinity scoring (BASELINE.json config 5), and cached-model set for
    cache-affinity scoring.

    ``gpu_free``/``gpu_memory_free_bytes`` mean "allocatable to this
    framework" (capacity minus external/system usage). They must NOT be
    reduced by the framework's own bound replicas: the controller
    re-solves every placement from these values each tick, so
    self-subtraction double-counts and destabilizes placements.
    """

    KIND = "Node"
    API_VERSION = "ai.kubeinfer-tpu.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    gpu_capacity: float = 0.0
    gpu_free: float = 0.0
    gpu_memory_bytes: int = 0
    gpu_memory_free_bytes: int = 0
    # Topology features: e.g. (rack, island) coordinates; same-coordinate
    # placements are rewarded by the affinity term in the cost matrix.
    topology: tuple[int, int] = (0, 0)
    cached_models: list[str] = field(default_factory=list)
    ip: str = ""
    ready: bool = True
    heartbeat: float = 0.0
    # Serving-replica efficiency summary advertised by the node's
    # engine (batching.ContinuousEngine.stats_summary): occupancy,
    # queue depth, goodput, free KV blocks, prefix hit rate. Opaque to
    # the solver today — consumers are dashboards and future
    # load-aware routing; empty when the node runs no serving replica.
    serving_stats: dict = field(default_factory=dict)

    def deepcopy(self) -> "NodeState":
        return copy.deepcopy(self)

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": self.API_VERSION,
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "gpuCapacity": self.gpu_capacity,
            "gpuFree": self.gpu_free,
            "gpuMemoryBytes": self.gpu_memory_bytes,
            "gpuMemoryFreeBytes": self.gpu_memory_free_bytes,
            "topology": list(self.topology),
            "cachedModels": list(self.cached_models),
            "ip": self.ip,
            "ready": self.ready,
            "heartbeat": self.heartbeat,
            "servingStats": dict(self.serving_stats),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "NodeState":
        topo = list(d.get("topology") or [])
        topo = (topo + [0, 0])[:2]  # tolerate short/long topology vectors
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            gpu_capacity=float(d.get("gpuCapacity", 0.0)),
            gpu_free=float(d.get("gpuFree", 0.0)),
            gpu_memory_bytes=int(d.get("gpuMemoryBytes", 0)),
            gpu_memory_free_bytes=int(d.get("gpuMemoryFreeBytes", 0)),
            topology=(int(topo[0]), int(topo[1])),
            cached_models=list(d.get("cachedModels") or []),
            ip=d.get("ip", ""),
            ready=bool(d.get("ready", True)),
            heartbeat=float(d.get("heartbeat", 0.0)),
            serving_stats=dict(d.get("servingStats") or {}),
        )
