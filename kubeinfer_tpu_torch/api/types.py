"""Resource types for the kubeinfer_tpu API group.

Parity target: reference api/v1/llmservice_types.go:25-98 — an ``LLMService``
resource with spec fields (model required; replicas >= 1 default 1;
gpuPerReplica >= 0 default 0; cacheStrategy enum none|shared default none;
image defaulted; gpuMemory matching ``^\\d+(Gi|Mi)$``) and a status carrying
available replicas, conditions, and the elected cache coordinator.

Differences from the reference (deliberate, per SURVEY.md §0/§7):

- ``schedulerPolicy`` is a first-class spec field selecting the
  ``SchedulerBackend`` that places the job's replicas (the reference declares
  scheduling-relevant fields but never reads them; placement is delegated to
  kube-scheduler).
- ``gpuMemory`` is parsed into bytes at validation time so it can feed the
  solver's demand vectors instead of being a write-only string.
- ``priority`` and ``gang`` fields feed the preemption / gang-scheduling
  solver paths (BASELINE.json configs 3-4).

Types are plain Python dataclasses with explicit defaulting + validation
(the equivalent of the kubebuilder CRD schema in
config/crd/bases/ai.ruijie.io_llmservices.yaml:45-60), serialized to/from
dicts for storage in the control plane.

A copy of ``kubeinfer_tpu/api/types.py`` for the PyTorch port. The dict
form is the reference's, key for key: the two stores read each other's
objects.
"""

from __future__ import annotations

import copy
import re
from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class ValidationError(ValueError):
    """Raised when a resource fails schema validation (CRD-schema equivalent)."""


class CacheStrategy(str, Enum):
    """How model weights are provisioned across a job's replicas.

    ``NONE``: every replica downloads the model itself.
    ``SHARED``: one elected coordinator downloads once; followers pull from it
    over the cluster network (the reference's coordinator/follower plane,
    internal/agent/coordinator/coordinator.go + internal/agent/follower/).
    """

    NONE = "none"
    SHARED = "shared"


class RuntimeKind(str, Enum):
    """Which inference engine serves the model.

    ``VLLM``: external vLLM process (reference behavior, vllm.go:95).
    ``NATIVE``: the framework's TPU-native JAX engine
    (kubeinfer_tpu.inference).
    """

    VLLM = "vllm"
    NATIVE = "native"


class SchedulerPolicy(str, Enum):
    """Which SchedulerBackend places a job's replicas.

    ``NATIVE_GREEDY``: serial first-fit-decreasing scorer in C++ (the
    comparison baseline).
    ``JAX_GREEDY``: batched parallel greedy with conflict resolution.
    ``JAX_AUCTION``: auction assignment, one replica per node.
    """

    NATIVE_GREEDY = "native-greedy"
    JAX_GREEDY = "jax-greedy"
    JAX_AUCTION = "jax-auction"


_QUANTITY_RE = re.compile(r"^(\d+)(Gi|Mi)$")
_UNIT_BYTES = {"Gi": 1024**3, "Mi": 1024**2}


def parse_quantity(s: str) -> int:
    """Parse a ``<int>(Gi|Mi)`` memory quantity into bytes.

    Pattern parity: reference api/v1/llmservice_types.go:49
    (``^\\d+(Gi|Mi)$``).
    """
    m = _QUANTITY_RE.match(s)
    if not m:
        raise ValidationError(f"gpuMemory {s!r} must match ^\\d+(Gi|Mi)$")
    return int(m.group(1)) * _UNIT_BYTES[m.group(2)]


DEFAULT_IMAGE = "vllm/vllm-openai:latest"


def _coerce_int(v: Any, field_name: str) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        raise ValidationError(f"{field_name} must be an integer, got {v!r}")


def _coerce_float(v: Any, field_name: str) -> float:
    try:
        return float(v)
    except (TypeError, ValueError):
        raise ValidationError(f"{field_name} must be a number, got {v!r}")


@dataclass
class ObjectMeta:
    """Standard object metadata (the metav1.ObjectMeta subset we need)."""

    name: str = ""
    namespace: str = "default"
    uid: str = ""
    resource_version: int = 0
    generation: int = 1
    labels: dict[str, str] = field(default_factory=dict)
    annotations: dict[str, str] = field(default_factory=dict)
    owner_references: list[dict[str, str]] = field(default_factory=list)
    creation_timestamp: float = 0.0
    deletion_timestamp: float | None = None

    def to_dict(self) -> dict[str, Any]:
        return {
            "name": self.name,
            "namespace": self.namespace,
            "uid": self.uid,
            "resourceVersion": self.resource_version,
            "generation": self.generation,
            "labels": dict(self.labels),
            "annotations": dict(self.annotations),
            "ownerReferences": [dict(r) for r in self.owner_references],
            "creationTimestamp": self.creation_timestamp,
            "deletionTimestamp": self.deletion_timestamp,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ObjectMeta":
        return cls(
            name=d.get("name", ""),
            namespace=d.get("namespace", "default"),
            uid=d.get("uid", ""),
            resource_version=_coerce_int(d.get("resourceVersion", 0), "metadata.resourceVersion"),
            generation=_coerce_int(d.get("generation", 1), "metadata.generation"),
            labels=dict(d.get("labels") or {}),
            annotations=dict(d.get("annotations") or {}),
            owner_references=[dict(r) for r in (d.get("ownerReferences") or [])],
            creation_timestamp=_coerce_float(
                d.get("creationTimestamp", 0.0), "metadata.creationTimestamp"
            ),
            deletion_timestamp=d.get("deletionTimestamp"),
        )


@dataclass
class LLMServiceSpec:
    """Desired state of an LLMService (reference llmservice_types.go:25-52).

    ``model`` is the HuggingFace model id, e.g. ``deepseek-ai/deepseek-r1``.
    """

    model: str = ""
    replicas: int = 1
    gpu_per_replica: int = 0
    cache_strategy: CacheStrategy = CacheStrategy.NONE
    image: str = DEFAULT_IMAGE
    gpu_memory: str = ""
    # New fields (not in reference; feed the solver):
    scheduler_policy: SchedulerPolicy = SchedulerPolicy.JAX_GREEDY
    priority: int = 0
    gang: bool = False  # all-or-nothing placement of the replica group
    max_model_len: int = 0  # 0 = runtime default
    # New: which engine serves the model (vllm = reference pass-through,
    # native = the in-framework TPU engine).
    runtime: RuntimeKind = RuntimeKind.VLLM

    def __post_init__(self) -> None:
        # Defaulting happens at construction so direct construction,
        # from_dict, and round-trips all agree (empty image == default).
        if not self.image:
            self.image = DEFAULT_IMAGE

    def gpu_memory_bytes(self) -> int:
        """Parsed gpuMemory demand, 0 when unset."""
        return parse_quantity(self.gpu_memory) if self.gpu_memory else 0

    def validate(self) -> None:
        """CRD-schema-equivalent validation (reference CRD yaml:45-60)."""
        if not self.model:
            raise ValidationError("spec.model is required")
        if self.replicas < 1:
            raise ValidationError("spec.replicas must be >= 1")
        if self.gpu_per_replica < 0:
            raise ValidationError("spec.gpuPerReplica must be >= 0")
        if not isinstance(self.cache_strategy, CacheStrategy):
            raise ValidationError(
                f"spec.cacheStrategy must be one of {[c.value for c in CacheStrategy]}"
            )
        if not isinstance(self.scheduler_policy, SchedulerPolicy):
            raise ValidationError(
                f"spec.schedulerPolicy must be one of {[p.value for p in SchedulerPolicy]}"
            )
        if not isinstance(self.runtime, RuntimeKind):
            raise ValidationError(
                f"spec.runtime must be one of {[r.value for r in RuntimeKind]}"
            )
        if self.gpu_memory:
            parse_quantity(self.gpu_memory)
        if self.priority < 0:
            raise ValidationError("spec.priority must be >= 0")

    def to_dict(self) -> dict[str, Any]:
        return {
            "model": self.model,
            "replicas": self.replicas,
            "gpuPerReplica": self.gpu_per_replica,
            "cacheStrategy": self.cache_strategy.value,
            "image": self.image,
            "gpuMemory": self.gpu_memory,
            "schedulerPolicy": self.scheduler_policy.value,
            "priority": self.priority,
            "gang": self.gang,
            "maxModelLen": self.max_model_len,
            "runtime": self.runtime.value,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LLMServiceSpec":
        try:
            cache = CacheStrategy(d.get("cacheStrategy", "none"))
        except ValueError:
            raise ValidationError(
                f"spec.cacheStrategy must be one of {[c.value for c in CacheStrategy]}, "
                f"got {d.get('cacheStrategy')!r}"
            )
        try:
            policy = SchedulerPolicy(d.get("schedulerPolicy", SchedulerPolicy.JAX_GREEDY.value))
        except ValueError:
            raise ValidationError(
                f"spec.schedulerPolicy must be one of {[p.value for p in SchedulerPolicy]}, "
                f"got {d.get('schedulerPolicy')!r}"
            )
        gpu_memory = d.get("gpuMemory", "") or ""
        if gpu_memory:
            parse_quantity(gpu_memory)  # reject malformed quantities at the boundary
        try:
            runtime = RuntimeKind(d.get("runtime", RuntimeKind.VLLM.value))
        except ValueError:
            raise ValidationError(
                f"spec.runtime must be one of {[r.value for r in RuntimeKind]}, "
                f"got {d.get('runtime')!r}"
            )
        return cls(
            model=d.get("model", ""),
            replicas=_coerce_int(d.get("replicas", 1), "spec.replicas"),
            gpu_per_replica=_coerce_int(d.get("gpuPerReplica", 0), "spec.gpuPerReplica"),
            cache_strategy=cache,
            image=d.get("image") or DEFAULT_IMAGE,
            gpu_memory=gpu_memory,
            scheduler_policy=policy,
            priority=_coerce_int(d.get("priority", 0), "spec.priority"),
            gang=bool(d.get("gang", False)),
            max_model_len=_coerce_int(d.get("maxModelLen", 0), "spec.maxModelLen"),
            runtime=runtime,
        )


@dataclass
class Condition:
    """Status condition (reference LLMServiceCondition, llmservice_types.go:92-98)."""

    type: str
    status: str  # "True" | "False" | "Unknown"
    reason: str = ""
    message: str = ""
    # Callers stamp this from their Clock; a real-time default here would
    # leak wall-clock into SimulatedClock tests (conditions created "now"
    # would sit ~1.7e9s in the simulated future and never go stale).
    last_update_time: float = 0.0

    def to_dict(self) -> dict[str, Any]:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastUpdateTime": self.last_update_time,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Condition":
        return cls(
            type=d.get("type", ""),
            status=d.get("status", "Unknown"),
            reason=d.get("reason", ""),
            message=d.get("message", ""),
            last_update_time=_coerce_float(
                d.get("lastUpdateTime", 0.0), "condition.lastUpdateTime"
            ),
        )


@dataclass
class LLMServiceStatus:
    """Observed state (reference LLMServiceStatus, llmservice_types.go:55-61),
    extended with the solver's placement output."""

    available_replicas: int = 0
    conditions: list[Condition] = field(default_factory=list)
    cache_coordinator: str = ""
    # New: where the solver placed each replica (node names, "" = unplaced).
    placements: list[str] = field(default_factory=list)
    phase: str = "Pending"  # Pending | Scheduling | Running | Degraded | Failed

    def set_condition(self, cond: Condition) -> None:
        for i, c in enumerate(self.conditions):
            if c.type == cond.type:
                self.conditions[i] = cond
                return
        self.conditions.append(cond)

    def get_condition(self, type_: str) -> Condition | None:
        for c in self.conditions:
            if c.type == type_:
                return c
        return None

    def to_dict(self) -> dict[str, Any]:
        return {
            "availableReplicas": self.available_replicas,
            "conditions": [c.to_dict() for c in self.conditions],
            "cacheCoordinator": self.cache_coordinator,
            "placements": list(self.placements),
            "phase": self.phase,
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LLMServiceStatus":
        return cls(
            available_replicas=_coerce_int(
                d.get("availableReplicas", 0), "status.availableReplicas"
            ),
            conditions=[Condition.from_dict(c) for c in (d.get("conditions") or [])],
            cache_coordinator=d.get("cacheCoordinator", ""),
            placements=list(d.get("placements") or []),
            phase=d.get("phase", "Pending"),
        )


@dataclass
class LLMService:
    """The LLMService resource (reference llmservice_types.go:67-81)."""

    KIND = "LLMService"
    API_VERSION = "ai.kubeinfer-tpu.io/v1"

    metadata: ObjectMeta = field(default_factory=ObjectMeta)
    spec: LLMServiceSpec = field(default_factory=LLMServiceSpec)
    status: LLMServiceStatus = field(default_factory=LLMServiceStatus)

    def validate(self) -> None:
        if not self.metadata.name:
            raise ValidationError("metadata.name is required")
        self.spec.validate()

    def deepcopy(self) -> "LLMService":
        return copy.deepcopy(self)

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": self.API_VERSION,
            "kind": self.KIND,
            "metadata": self.metadata.to_dict(),
            "spec": self.spec.to_dict(),
            "status": self.status.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "LLMService":
        return cls(
            metadata=ObjectMeta.from_dict(d.get("metadata") or {}),
            spec=LLMServiceSpec.from_dict(d.get("spec") or {}),
            status=LLMServiceStatus.from_dict(d.get("status") or {}),
        )


@dataclass
class LLMServiceList:
    """List type (reference llmservice_types.go:86-90)."""

    items: list[LLMService] = field(default_factory=list)

    def to_dict(self) -> dict[str, Any]:
        return {
            "apiVersion": LLMService.API_VERSION,
            "kind": "LLMServiceList",
            "items": [i.to_dict() for i in self.items],
        }
