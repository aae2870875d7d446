"""Two processes on two cards over NCCL (``cuda``-marked; skips with
fewer than two cards). No JAX here. This file, run as a script (``python
tests/test_torch_distributed_card.py <rank> <n> <port>``), is the worker:
each worker joins an NCCL group on its own card
(``KUBEINFER_LOCAL_DEVICE_IDS``), builds the global mesh (one job row a
process) and solves a seeded 10k x 1k problem sharded; both assignments
equal, bitwise, the one-card ``solve_greedy(accel="pallas")`` of the same
problem in the test's own process, where every round kernel runs too."""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np

FIELDS = ("node", "gpu_free", "mem_free", "rounds", "placed")


def problem(device):
    """A seeded 10k x 1k problem with 30% incumbents and 4 priority
    classes, in descending priority order."""
    import torch

    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    rng = np.random.default_rng(24)
    J, N = 10000, 1000
    buf, _, _, Jp, Np = pack_problem_arrays(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=np.sort(rng.integers(0, 4, J))[::-1].astype(np.float32),
        job_model=rng.integers(0, 64, J).astype(np.int32),
        job_current_node=np.where(rng.random(J) < 0.3,
                                  rng.integers(0, N, J), -1).astype(np.int32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=rng.random((N, 64)) < 0.05,
        node_topology=rng.integers(0, 16, N).astype(np.int32),
        job_multiple=2,
    )
    return unpack_problem(buf, Jp, Np, torch.device(device))


def worker(rank: int, nprocs: int, port: int) -> None:
    import torch

    from kubeinfer_tpu_torch import distributed
    from kubeinfer_tpu_torch.solver.sharded import solve_sharded

    cfg = distributed.DistributedConfig(f"127.0.0.1:{port}", rank, nprocs,
                                        (rank,))
    assert distributed.initialize(cfg)  # NCCL: the process's card is CUDA
    assert torch.distributed.get_backend() == "nccl"
    mesh = distributed.global_mesh()
    dev = f"cuda:{rank}"
    out = solve_sharded(problem(dev), mesh)
    result = {k: getattr(out, k).cpu().numpy().tobytes().hex()
              for k in FIELDS}
    result.update(rank=rank, device=str(out.node.device),
                  jax_imported="jax" in sys.modules)
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402


@pytest.mark.cuda
def test_two_cards_nccl_solve_matches_one_card():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs 2 NVIDIA cards")
    from kubeinfer_tpu_torch.solver.core import solve_greedy

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), "2", str(port)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    want = solve_greedy(problem("cuda:0"), accel="pallas")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        got = json.loads(line[-1][len("RESULT "):])
        assert got["device"] == f"cuda:{rank}"
        assert not got["jax_imported"]
        for k in FIELDS:
            assert got[k] == getattr(want, k).cpu().numpy().tobytes().hex(), k
