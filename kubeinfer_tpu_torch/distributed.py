"""The multi-process runtime: ``torch.distributed`` bootstrap, the global
(jobs, nodes) mesh, and the one cross-process collective.

Counterpart of ``kubeinfer_tpu/distributed.py``, with its names and its
environment contract. The reference joins ``jax.distributed`` and builds
one mesh over every process's devices; the port joins a
``torch.distributed`` process group (TCP rendezvous at the coordinator)
and builds the same mesh as a :class:`~kubeinfer_tpu_torch.inference.
sharding.Mesh` whose ``owners`` record which process holds each position.

Topology, as in the reference: the solver's ``jobs`` axis spans processes
(each process contributes its devices as job-parallel rows), so the only
traffic between processes is a few [J] and [N] vectors a round, while
the [N, J] cost field never leaves its device. The ``nodes`` axis stays
inside a process.

Bootstrap env contract (set by the deployment layer; all optional,
absent means one process):

  KUBEINFER_COORDINATOR       "host:port" of process 0 (the TCP store)
  KUBEINFER_PROCESS_ID        this process's rank, 0-based
  KUBEINFER_NUM_PROCESSES     total process count
  KUBEINFER_LOCAL_DEVICE_IDS  optional comma list of the CUDA cards this
                              process uses (default: every visible card)

``initialize()`` is idempotent and a no-op without the env, so every
entry point can call it unconditionally (the manager does at start).
The backend is NCCL for a process on CUDA cards and gloo on the CPU; a
caller may name gloo for CUDA cards, which is how two processes share one
card (NCCL refuses two ranks on one GPU). Nothing here changes backend or
device on its own: a failed start or collective raises.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from kubeinfer_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

# this process's devices once it has joined (None until then)
_local_devices: list[torch.device] | None = None


@dataclass(frozen=True)
class DistributedConfig:
    coordinator_address: str
    process_id: int
    num_processes: int
    local_device_ids: tuple[int, ...] | None = None


def config_from_env(env=None) -> DistributedConfig | None:
    """Parse the bootstrap env; None = single-process (no env set).

    Raises ValueError when the env is partially set: a half-configured
    fleet must fail loudly at startup, not hang in ``initialize()``."""
    env = os.environ if env is None else env
    addr = env.get("KUBEINFER_COORDINATOR", "")
    pid = env.get("KUBEINFER_PROCESS_ID", "")
    nproc = env.get("KUBEINFER_NUM_PROCESSES", "")
    if not addr and not pid and not nproc:
        return None
    if not (addr and pid and nproc):
        raise ValueError(
            "partial distributed env: KUBEINFER_COORDINATOR, "
            "KUBEINFER_PROCESS_ID and KUBEINFER_NUM_PROCESSES must all be "
            f"set (got coordinator={addr!r}, id={pid!r}, n={nproc!r})"
        )
    process_id = int(pid)
    num_processes = int(nproc)
    if not (0 <= process_id < num_processes):
        raise ValueError(
            f"process id {process_id} outside [0, {num_processes})"
        )
    ids = env.get("KUBEINFER_LOCAL_DEVICE_IDS", "")
    local = tuple(int(x) for x in ids.split(",") if x) if ids else None
    return DistributedConfig(addr, process_id, num_processes, local)


def _devices_of(cfg: DistributedConfig, device) -> list[torch.device]:
    """The process's devices: the CPU when ``device`` names it, else the
    CUDA cards of ``cfg.local_device_ids`` (every visible card when
    unset); a missing card raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    count = torch.cuda.device_count()
    ids = (list(cfg.local_device_ids) if cfg.local_device_ids is not None
           else list(range(count)))
    bad = [i for i in ids if not 0 <= i < count]
    if bad or not ids:
        raise ValueError(f"local device ids {ids} outside the {count} "
                         "visible CUDA cards")
    return [torch.device("cuda", i) for i in ids]


def initialize(cfg: DistributedConfig | None = None, env=None,
               backend: str | None = None, device=None) -> bool:
    """Join the ``torch.distributed`` process group (no-op single-process).

    Returns True when running multi-process. Safe to call more than once.
    ``device`` is as every entry point's (None is the CUDA card, "cpu"
    the CPU); ``backend=None`` is "nccl" on CUDA cards and "gloo" on the
    CPU."""
    global _local_devices
    if cfg is None:
        cfg = config_from_env(env)
    if cfg is None or cfg.num_processes <= 1:
        return False
    if _local_devices is not None:
        return True
    devices = _devices_of(cfg, device)
    on_cuda = devices[0].type == "cuda"
    if backend is None:
        backend = "nccl" if on_cuda else "gloo"
    if backend == "nccl" and not on_cuda:
        raise ValueError("the nccl backend needs CUDA cards; the CPU runs "
                         "gloo")
    if on_cuda:
        torch.cuda.set_device(devices[0])
    dist.init_process_group(
        backend, init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id,
    )
    _local_devices = devices
    log.info("joined distributed runtime: process %d/%d via %s (%s, %s)",
             cfg.process_id, cfg.num_processes, cfg.coordinator_address,
             backend, ", ".join(map(str, devices)))
    return True


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> list[torch.device] | None:
    """The devices this process joined with (None before ``initialize``)."""
    return _local_devices


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """THE cross-process collective: every process's ``t`` (one shape and
    dtype on every process), in rank order, on ``t``'s device; ``[t]`` in
    one process. Callers fold the list in rank order, so no result
    depends on the backend's reduction order. gloo's all_gather takes
    host tensors, so under gloo a CUDA tensor is staged through host
    memory both ways: that is gloo's transport, chosen by the backend."""
    if process_count() <= 1:
        return [t]
    staged = t.device.type == "cuda" and dist.get_backend() == "gloo"
    src = t.cpu() if staged else t.contiguous()
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out] if staged else out


def global_mesh(node_axis: int = 1, devices=None):
    """(jobs, nodes) mesh over every process's devices.

    One process: ``solver.sharded.make_mesh`` over ``devices`` (every
    visible card when None). Several: each process's devices (those it
    joined with, or ``devices``) stack process-major along ``jobs``, so
    the cross-process traffic is the small [J]/[N] vectors and every
    ``nodes`` row stays inside one process. ``node_axis`` must divide
    each process's device count: a nodes shard must never span
    processes."""
    from kubeinfer_tpu_torch.inference.sharding import Mesh, _device
    from kubeinfer_tpu_torch.solver.sharded import make_mesh

    if process_count() <= 1:
        return make_mesh(node_axis=node_axis, devices=devices)
    mine = [_device(d) for d in (devices or _local_devices or [])]
    names: list = [None] * process_count()
    dist.all_gather_object(names, [str(d) for d in mine])
    per_host = len(mine)
    if any(len(n) != per_host for n in names):
        raise ValueError(f"processes hold unequal device counts: {names}")
    if node_axis < 1 or node_axis > per_host or per_host % node_axis:
        raise ValueError(
            f"node_axis {node_axis} must divide the per-host device count "
            f"{per_host}: a nodes shard must never span DCN"
        )
    ordered = [torch.device(n) for host in names for n in host]
    owners = np.repeat(np.arange(len(names)), per_host)
    job_axis = len(ordered) // node_axis
    arr = np.empty(len(ordered), dtype=object)
    arr[:] = ordered
    return Mesh(arr.reshape(job_axis, node_axis), ("jobs", "nodes"),
                owners=owners.reshape(job_axis, node_axis))
