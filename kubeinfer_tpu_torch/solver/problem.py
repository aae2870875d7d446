"""Static-shape tensor encoding of a scheduling problem (PyTorch port).

Counterpart of ``kubeinfer_tpu/solver/problem.py``. Both axes are padded
to bucketed sizes so every shape the solver sees comes from a small set;
padding rows and columns are marked invalid and can never be chosen. The
host-side packing is numpy and is copied from the reference, so the packed
buffer is byte-equal to it; ``unpack_problem`` turns that buffer into
tensor views on the target device after ONE host-to-device copy.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

BUCKETS = (
    64, 128, 256, 384, 512, 768, 1024, 1536, 2048, 3072, 4096, 6144,
    8192, 12288, 16384, 24576, 32768, 49152, 65536,
)

# Max distinct model ids participating in cache-affinity scoring per solve.
# Models beyond the table share slot 0 ("no affinity").
MAX_MODELS = 256

GIB = float(1024**3)

_CACHED_WORDS = MAX_MODELS // 4  # f32 words per node of cached bitmap


def bucket_size(n: int) -> int:
    """Smallest bucket >= n (>= 1)."""
    for b in BUCKETS:
        if n <= b:
            return b
    raise ValueError(f"problem axis {n} exceeds max bucket {BUCKETS[-1]}")


def _moved(obj, device: torch.device):
    return type(obj)(
        **{
            f.name: getattr(obj, f.name).to(device)
            for f in dataclasses.fields(obj)
        }
    )


@dataclass
class JobSet:
    """Padded job-side tensors (length J), one row per replica to place."""

    gpu_demand: torch.Tensor  # f32[J]
    mem_demand: torch.Tensor  # f32[J] GiB
    priority: torch.Tensor  # f32[J] higher = more important
    gang_id: torch.Tensor  # i32[J] -1 = no gang
    model_id: torch.Tensor  # i32[J] slot in the model table (0 = none)
    current_node: torch.Tensor  # i32[J] incumbent node, -1 = unplaced
    valid: torch.Tensor  # bool[J] padding mask


@dataclass
class NodeSet:
    """Padded node-side tensors (length N)."""

    gpu_free: torch.Tensor  # f32[N]
    mem_free: torch.Tensor  # f32[N] GiB
    gpu_capacity: torch.Tensor  # f32[N]
    mem_capacity: torch.Tensor  # f32[N]
    topology: torch.Tensor  # i32[N] topology group id
    cached: torch.Tensor  # bool[N, MAX_MODELS]
    valid: torch.Tensor  # bool[N]


@dataclass
class Problem:
    """One tick's scheduling problem, on one device."""

    jobs: JobSet
    nodes: NodeSet

    @property
    def device(self) -> torch.device:
        return self.jobs.gpu_demand.device

    def to(self, device: torch.device) -> "Problem":
        if self.device == device:
            return self
        return Problem(_moved(self.jobs, device), _moved(self.nodes, device))


def _densify_gangs(gang: np.ndarray) -> np.ndarray:
    """Remap arbitrary gang ids to dense [0, n_gangs) so they always fit
    the solver's bound (gang ids must be < J; see core._gang_repair)."""
    out = np.full(gang.shape, -1, np.int32)
    mask = gang >= 0
    if mask.any():
        _, inverse = np.unique(gang[mask], return_inverse=True)
        out[mask] = inverse.astype(np.int32)
    return out


def _padded_sizes(
    J_true: int, N_true: int, job_multiple: int, node_multiple: int
) -> tuple[int, int]:
    """Bucketed padded axis sizes, rounded up to the given multiples."""
    J = bucket_size(max(J_true, 1))
    N = bucket_size(max(N_true, 1))
    J = -(-J // max(job_multiple, 1)) * max(job_multiple, 1)
    N = -(-N // max(node_multiple, 1)) * max(node_multiple, 1)
    return J, N


def _clamp_model_ids(jm: np.ndarray) -> np.ndarray:
    """Out-of-table model slots collapse to 0 ("no affinity")."""
    return np.where((jm >= 0) & (jm < MAX_MODELS), jm, 0)


# --- single-buffer packing (one host->device transfer per solve) -----------
#
# Layout, in 4-byte words (J/N are the padded bucket sizes):
#   [0,   3J) job f32 fields: gpu_demand, mem_demand, priority
#   [3J,  7J) job i32 fields: gang_id, model_id, current_node, valid
#   [7J, 7J+4N) node f32 fields: gpu_free, mem_free, gpu_capacity,
#               mem_capacity
#   [7J+4N, 7J+6N) node i32 fields: topology, valid
#   [7J+6N, 7J+6N+N*MAX_MODELS/4) cached bitmap, uint8[N, MAX_MODELS]


def packed_words(J: int, N: int) -> int:
    return 7 * J + 6 * N + N * _CACHED_WORDS


def pack_problem_arrays(
    *,
    job_gpu: np.ndarray,
    job_mem_gib: np.ndarray,
    job_priority: np.ndarray | None = None,
    job_gang: np.ndarray | None = None,
    job_model: np.ndarray | None = None,
    job_current_node: np.ndarray | None = None,
    node_gpu_free: np.ndarray,
    node_mem_free_gib: np.ndarray,
    node_gpu_capacity: np.ndarray | None = None,
    node_mem_capacity_gib: np.ndarray | None = None,
    node_topology: np.ndarray | None = None,
    node_cached: np.ndarray | None = None,
    job_multiple: int = 1,
    node_multiple: int = 1,
    job_perm: np.ndarray | None = None,
) -> tuple[np.ndarray, int, int, int, int]:
    """Host-side packing. Returns ``(buf f32[packed_words], J_true, N_true,
    J, N)``. ``job_perm`` applies the backend's priority permutation during
    the field copies (see scheduler/backends.py)."""
    J_true = int(job_gpu.shape[0])
    N_true = int(node_gpu_free.shape[0])
    J, N = _padded_sizes(J_true, N_true, job_multiple, node_multiple)

    # np.empty + explicit pad fills: np.zeros would page-fault the whole
    # buffer lazily on first write; the pad tails are a fraction of it
    buf = np.empty(packed_words(J, N), np.float32)
    i32 = buf.view(np.int32)

    def putf(o, a, pad=0.0):
        dst = buf[o : o + J]
        dst[J_true:] = pad
        if a is None:
            dst[:J_true] = pad
        else:
            a = np.asarray(a)
            dst[:J_true] = a[job_perm] if job_perm is not None else a

    putf(0, job_gpu)
    putf(J, job_mem_gib)
    putf(2 * J, job_priority)
    gang = i32[3 * J : 4 * J]
    gang[J_true:] = -1
    if job_gang is not None:
        gang[:J_true] = _densify_gangs(
            np.asarray(job_gang, np.int32)[job_perm]
            if job_perm is not None
            else np.asarray(job_gang, np.int32)
        )
    else:
        gang[:J_true] = -1
    model = i32[4 * J : 5 * J]
    model[J_true:] = 0
    if job_model is not None:
        jm = np.asarray(job_model)
        if job_perm is not None:
            jm = jm[job_perm]
        model[:J_true] = _clamp_model_ids(jm)
    else:
        model[:J_true] = 0
    cur = i32[5 * J : 6 * J]
    cur[:] = -1
    if job_current_node is not None:
        jc = np.asarray(job_current_node, np.int32)
        cur[:J_true] = jc[job_perm] if job_perm is not None else jc
    jv = i32[6 * J : 7 * J]
    jv[:J_true] = 1
    jv[J_true:] = 0
    o = 7 * J

    def putn(off, a, fallback=None):
        dst = buf[off : off + N]
        dst[N_true:] = 0.0
        dst[:N_true] = a if a is not None else fallback

    putn(o, node_gpu_free)
    putn(o + N, node_mem_free_gib)
    putn(o + 2 * N, node_gpu_capacity, node_gpu_free)
    putn(o + 3 * N, node_mem_capacity_gib, node_mem_free_gib)
    topo = i32[o + 4 * N : o + 5 * N]
    topo[N_true:] = 0
    if node_topology is not None:
        topo[:N_true] = node_topology
    else:
        topo[:N_true] = 0
    nv = i32[o + 5 * N : o + 6 * N]
    nv[:N_true] = 1
    nv[N_true:] = 0
    cached = buf[o + 6 * N :].view(np.uint8).reshape(N, MAX_MODELS)
    if node_cached is not None:
        nc = np.asarray(node_cached)
        w = nc.shape[1]
        cached[:N_true, :w] = nc
        cached[:N_true, w:] = 0
        cached[N_true:] = 0
    else:
        cached[:] = 0
    return buf, J_true, N_true, J, N


def unpack_problem(
    buf: np.ndarray, J: int, N: int, device: torch.device
) -> Problem:
    """Inverse of ``pack_problem_arrays``: one host-to-device copy of the
    whole buffer (staged through pinned memory for a CUDA device), then
    views and dtype reinterpretations of slices of it — no per-field
    transfer and no value conversion."""
    host = torch.from_numpy(buf)
    if device.type == "cuda":
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        dev_buf = pinned.to(device, non_blocking=True)
    else:
        dev_buf = host.to(device)

    def f32(o, n):
        return dev_buf[o : o + n]

    def i32(o, n):
        return f32(o, n).view(torch.int32)

    o = 7 * J
    cached = f32(o + 6 * N, N * _CACHED_WORDS).view(torch.uint8)
    return Problem(
        jobs=JobSet(
            gpu_demand=f32(0, J),
            mem_demand=f32(J, J),
            priority=f32(2 * J, J),
            gang_id=i32(3 * J, J),
            model_id=i32(4 * J, J),
            current_node=i32(5 * J, J),
            valid=i32(6 * J, J) != 0,
        ),
        nodes=NodeSet(
            gpu_free=f32(o, N),
            mem_free=f32(o + N, N),
            gpu_capacity=f32(o + 2 * N, N),
            mem_capacity=f32(o + 3 * N, N),
            topology=i32(o + 4 * N, N),
            cached=cached.reshape(N, MAX_MODELS) != 0,
            valid=i32(o + 5 * N, N) != 0,
        ),
    )


_FIELD_DTYPES = {
    "gpu_demand": torch.float32, "mem_demand": torch.float32,
    "priority": torch.float32, "gang_id": torch.int32,
    "model_id": torch.int32, "current_node": torch.int32,
    "gpu_free": torch.float32, "mem_free": torch.float32,
    "gpu_capacity": torch.float32, "mem_capacity": torch.float32,
    "topology": torch.int32, "cached": torch.bool, "valid": torch.bool,
}


def problem_from_arrays(
    jobs: Mapping[str, np.ndarray],
    nodes: Mapping[str, np.ndarray],
    weights=None,
    *,
    device: torch.device | str,
):
    """Carry one solver state across from the reference: the fields of a
    ``kubeinfer_tpu`` Problem as numpy arrays (keyed by their field names)
    plus any object with ``ScoreWeights``' six fields. Returns the port's
    ``(Problem, ScoreWeights)`` on ``device``. The problem and the weights
    are this system's whole state — it has no model weights — so this is
    how a test feeds both packages the same input."""
    from kubeinfer_tpu_torch.solver.core import ScoreWeights

    dev = torch.device(device)

    def conv(cls, arrays):
        return cls(
            **{
                f.name: torch.from_numpy(np.array(arrays[f.name])).to(
                    device=dev, dtype=_FIELD_DTYPES[f.name]
                )
                for f in dataclasses.fields(cls)
            }
        )

    w = ScoreWeights() if weights is None else ScoreWeights(
        **{
            f.name: float(getattr(weights, f.name))
            for f in dataclasses.fields(ScoreWeights)
        }
    )
    return Problem(conv(JobSet, jobs), conv(NodeSet, nodes)), w
