"""The port's multi-process runtime against the JAX package's.

- ``config_from_env`` and ``initialize``: the cases of
  ``tests/test_distributed.py``, mirrored, plus the port's backend rules
  (NCCL never on the CPU, no card is an error and never a CPU run).
- ``global_mesh`` in one process, over ``["cpu"] * 8``.
- One two-process run: this file, run as a script (``python
  tests/test_torch_distributed.py <rank> <n> <port>``), is the worker.
  Two workers join a gloo group on the CPU, build the global mesh (one
  job row each) and solve the 64 x 16 problem of
  ``tests/testdata/distributed_worker.py`` (job_multiple 2). Each
  worker's assignment equals, bitwise, the reference's ``solve_sharded``
  on a (2, 1) mesh of its virtual devices, and no worker imports jax.
- The manager fails at start on a partial environment.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np


def worker_problem(nprocs: int):
    """The reference worker's problem, as numpy arguments (seed 0)."""
    rng = np.random.default_rng(0)
    return dict(
        job_gpu=rng.integers(1, 4, 64).astype(np.float32),
        job_mem_gib=rng.integers(1, 8, 64).astype(np.float32),
        node_gpu_free=np.full(16, 8.0, np.float32),
        node_mem_free_gib=np.full(16, 64.0, np.float32),
        job_multiple=nprocs,
    )


def worker(rank: int, nprocs: int, port: int) -> None:
    """Join the gloo group, solve sharded, print the result as JSON."""
    import torch

    from kubeinfer_tpu_torch import distributed
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )
    from kubeinfer_tpu_torch.solver.sharded import solve_sharded

    cfg = distributed.DistributedConfig(f"127.0.0.1:{port}", rank, nprocs)
    assert distributed.initialize(cfg, device="cpu")
    assert distributed.initialize(cfg, device="cpu")  # idempotent
    assert distributed.process_count() == nprocs
    assert distributed.process_index() == rank
    mesh = distributed.global_mesh(node_axis=1)
    assert mesh.shape == {"jobs": nprocs, "nodes": 1}
    assert mesh.owners[:, 0].tolist() == list(range(nprocs))
    buf, _, _, J, N = pack_problem_arrays(**worker_problem(nprocs))
    out = solve_sharded(unpack_problem(buf, J, N, torch.device("cpu")), mesh)
    result = {k: getattr(out, k).numpy().tobytes().hex()
              for k in ("node", "gpu_free", "mem_free", "rounds", "placed")}
    result.update(rank=rank, placed_n=int(out.placed),
                  jax_imported="jax" in sys.modules)
    torch.distributed.destroy_process_group()
    print("RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

from kubeinfer_tpu_torch import distributed  # noqa: E402
from kubeinfer_tpu_torch.distributed import (  # noqa: E402
    DistributedConfig,
    config_from_env,
)

CPU8 = ["cpu"] * 8


class TestConfigFromEnv:
    def test_absent_env_is_single_process(self):
        assert config_from_env({}) is None

    def test_full_env_parses(self):
        cfg = config_from_env({
            "KUBEINFER_COORDINATOR": "10.0.0.1:8476",
            "KUBEINFER_PROCESS_ID": "2",
            "KUBEINFER_NUM_PROCESSES": "4",
            "KUBEINFER_LOCAL_DEVICE_IDS": "0,1,2,3",
        })
        assert cfg == DistributedConfig("10.0.0.1:8476", 2, 4, (0, 1, 2, 3))

    def test_partial_env_fails_loudly(self):
        with pytest.raises(ValueError, match="partial distributed env"):
            config_from_env({"KUBEINFER_COORDINATOR": "10.0.0.1:8476"})

    def test_rank_out_of_range_rejected(self):
        with pytest.raises(ValueError, match="outside"):
            config_from_env({
                "KUBEINFER_COORDINATOR": "a:1",
                "KUBEINFER_PROCESS_ID": "4",
                "KUBEINFER_NUM_PROCESSES": "4",
            })


class TestInitialize:
    def test_no_env_is_noop(self):
        assert distributed.initialize(env={}) is False
        assert distributed.process_count() == 1
        assert distributed.process_index() == 0

    def test_single_process_config_is_noop(self):
        cfg = DistributedConfig("a:1", 0, 1)
        assert distributed.initialize(cfg) is False

    def test_nccl_is_never_taken_on_the_cpu(self):
        cfg = DistributedConfig("127.0.0.1:1", 0, 2)
        with pytest.raises(ValueError, match="nccl backend needs CUDA"):
            distributed.initialize(cfg, backend="nccl", device="cpu")
        assert not torch.distributed.is_initialized()

    @pytest.mark.skipif(torch.cuda.is_available(), reason="a card is here")
    def test_no_card_is_an_error_not_a_cpu_run(self):
        cfg = DistributedConfig("127.0.0.1:1", 0, 2, (0,))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.initialize(cfg)
        assert not torch.distributed.is_initialized()

    def test_one_process_gathers_itself(self):
        t = torch.arange(4)
        assert distributed.all_gather(t) == [t]


class TestGlobalMesh:
    def test_single_host_delegates(self):
        mesh = distributed.global_mesh(devices=CPU8)
        assert mesh.axis_names == ("jobs", "nodes")
        assert mesh.devices.size == 8

    def test_node_axis_constraint(self):
        mesh = distributed.global_mesh(node_axis=2, devices=CPU8)
        assert mesh.shape["nodes"] == 2
        assert mesh.shape["jobs"] == 4
        with pytest.raises(ValueError, match="node_axis 3"):
            distributed.global_mesh(node_axis=3, devices=CPU8)

    def test_sharded_solve_runs_on_global_mesh(self):
        from kubeinfer_tpu_torch.solver.problem import (
            pack_problem_arrays,
            unpack_problem,
        )
        from kubeinfer_tpu_torch.solver.sharded import solve_sharded

        buf, _, _, J, N = pack_problem_arrays(**worker_problem(1))
        p = unpack_problem(buf, J, N, torch.device("cpu"))
        out = solve_sharded(p, distributed.global_mesh(devices=CPU8))
        assert int(out.placed) > 0


def test_manager_fails_at_start_on_a_partial_env(monkeypatch):
    from kubeinfer_tpu_torch.manager import __main__ as mgr_main

    monkeypatch.setenv("KUBEINFER_COORDINATOR", "127.0.0.1:1")
    monkeypatch.delenv("KUBEINFER_PROCESS_ID", raising=False)
    monkeypatch.delenv("KUBEINFER_NUM_PROCESSES", raising=False)
    built = []
    monkeypatch.setattr(mgr_main, "Manager", lambda cfg: built.append(cfg))
    with pytest.raises(ValueError, match="partial distributed env"):
        mgr_main.main(["--device", "cpu"])
    assert not built  # nothing started


# --- two OS processes, one gloo group ---------------------------------------


@pytest.fixture(scope="module")
def two_process_run():
    from tests.conftest import scrubbed_pythonpath

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = scrubbed_pythonpath()
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), "2",
             str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for rank in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        # a wedged worker must not orphan the pair holding the port
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    results = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        line = [x for x in out.splitlines() if x.startswith("RESULT ")]
        assert line, f"rank {rank} printed no result:\n{out}"
        results.append(json.loads(line[-1][len("RESULT "):]))
    return results


def test_two_processes_agree(two_process_run):
    keys = ("node", "gpu_free", "mem_free", "rounds", "placed")
    a, b = two_process_run
    assert (a["rank"], b["rank"]) == (0, 1)
    assert [a[k] for k in keys] == [b[k] for k in keys]
    assert a["placed_n"] > 0


def test_two_processes_match_reference(two_process_run):
    import jax

    from kubeinfer_tpu.solver.problem import encode_problem_arrays
    from kubeinfer_tpu.solver.sharded import make_mesh, solve_sharded

    want = solve_sharded(encode_problem_arrays(**worker_problem(2)),
                         make_mesh(2))
    assert len(jax.devices()) == 8
    for got in two_process_run:
        for k in ("node", "gpu_free", "mem_free", "rounds", "placed"):
            assert got[k] == np.asarray(getattr(want, k)).tobytes().hex(), k


def test_workers_import_no_jax(two_process_run):
    assert not any(r["jax_imported"] for r in two_process_run)
