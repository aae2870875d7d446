"""Agent plane: per-node and per-replica runtime daemons.

Counterpart of ``kubeinfer_tpu/agent/``: the same modules, names and
behaviour over the port's store, lease, metrics and resilience layers.
The native runtime launches the port's server
(``kubeinfer_tpu_torch.inference.server``), and the probe asks
``torch.cuda`` for the node's cards.

Parity targets (reference internal/agent/*, cmd/agent/main.go):

- Lease election with coordinator/follower role flips (election.go via
  kubeinfer_tpu_torch.coordination).
- Coordinator: ensure model present (download once), serve it over HTTP
  (coordinator.go, model_server.go).
- Follower: pull model files from the coordinator instead of the WAN
  (follower.go) — extended with resumable, subdirectory-safe transfers
  (both called out as reference gaps: follower.go:117-149 "no retry/
  resume", SURVEY.md §2 #9 flat-file-only).
- Inference runtime lifecycle: spawn/configure/stop the serving process
  (vllm.go).
- NEW duty (north star): agents report node-state vectors (NodeState) that
  feed the solver's node tensor, and act as the kubelet-equivalent that
  starts replica agents for workload replicas bound to their node.
"""

from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig, RuntimeServer
from kubeinfer_tpu_torch.agent.model_server import ModelServer
from kubeinfer_tpu_torch.agent.coordinator import Coordinator
from kubeinfer_tpu_torch.agent.follower import Follower
from kubeinfer_tpu_torch.agent.node_agent import NodeAgent, ReplicaAgent

__all__ = [
    "Coordinator",
    "Follower",
    "ModelServer",
    "NodeAgent",
    "ReplicaAgent",
    "RuntimeConfig",
    "RuntimeServer",
]
