"""The port's scheduler backend and package boundary.

``TorchBackend(device="cpu")`` is held against the JAX package's packed
solve under the reference's own routing on its accelerator
(``core._resolve_accel``): ``accel="mega-jnp"`` when both bucket axes are
128-aligned and a mega window fits, else ``accel="jnp"``, the pipelined
loop (``JaxBackend`` itself takes jnp for every shape on the CPU): same
priority sort, same packed buffer, same seeded rule, same assignment and
rounds.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from kubeinfer_tpu.scheduler import backends as jb
from kubeinfer_tpu_torch.scheduler import backends as tb

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "kubeinfer_tpu_torch"


def make_request(J, N, seed, gang_frac=0.0, inc_frac=0.0):
    rng = np.random.default_rng(seed)
    gang = np.where(rng.random(J) < gang_frac, rng.integers(0, J // 4 + 1, J), -1)
    cur = np.where(rng.random(J) < inc_frac, rng.integers(0, N, J), -1)
    return tb.SolveRequest(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        job_gang=gang.astype(np.int32) if gang_frac else None,
        job_model=rng.integers(0, 256, J).astype(np.int32),
        job_current_node=cur.astype(np.int32) if inc_frac else None,
        node_gpu_free=rng.choice([16.0, 32.0, 64.0], N).astype(np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=(rng.random((N, 256)) < 0.02).astype(np.uint8),
        node_topology=rng.integers(0, 16, N).astype(np.int32),
    )


def reference_accel(J, N):
    """``core._resolve_accel("auto")`` on the reference's accelerator, with
    the jnp twins standing in for the TPU kernels."""
    from kubeinfer_tpu.solver import pallas_kernels as pk

    if J % 128 == 0 and N % 128 == 0 and pk.mega_window(N, J) is not None:
        return "mega-jnp"
    return "jnp"


def jax_packed_solve(req):
    """The JAX package's packed solve as its accelerator routes it, with
    the same priority sort and un-permute JaxBackend applies."""
    from kubeinfer_tpu.solver.problem import pack_problem_arrays

    perm = None
    pr = req.job_priority
    if pr is not None and np.any(pr[1:] > pr[:-1]):
        perm = jb._descending_stable_perm(pr)
    buf, _, _, J, N = pack_problem_arrays(
        **{k: v for k, v in req.__dict__.items()}, job_perm=perm
    )
    out = jb._packed_solver()(
        buf, J=J, N=N, policy="jax-greedy", accel=reference_accel(J, N),
        seeded=jb.request_has_incumbents(req.job_current_node),
    )
    node = np.asarray(out.node)[: req.num_jobs]
    if perm is not None:
        un = np.empty_like(node)
        un[perm] = node
        node = un
    return node, int(out.rounds)


@pytest.mark.parametrize(
    "J,N,seed,gang_frac,inc_frac",
    [(300, 40, 0, 0.0, 0.0), (700, 60, 1, 0.25, 0.0),
     (500, 50, 2, 0.0, 0.3), (32, 8, 3, 0.0, 0.0),
     (1000, 100, 3, 0.2, 0.2), (1500, 200, 6, 0.1, 0.2)],
)
def test_backend_matches_jax_packed_mega(J, N, seed, gang_frac, inc_frac):
    """The first four buckets are unaligned (N pads to 64: the pipelined
    loop); the last two are 128-aligned with a window (mega)."""
    req = make_request(J, N, seed, gang_frac, inc_frac)
    res = tb.TorchBackend(device="cpu").solve(req)
    node, rounds = jax_packed_solve(req)
    np.testing.assert_array_equal(res.assignment, node)
    assert res.rounds == rounds
    assert res.placed == int((node >= 0).sum())
    assert res.policy == "jax-greedy" and res.extras["encode_ms"] >= 0
    if (J, N) == (700, 60):
        assert res.placed == 601


def test_solve_service_handler_json_round_trip():
    rng = np.random.default_rng(9)
    J, N = 120, 16
    body = {
        "policy": "jax-greedy",
        "jobs": {
            "gpu": rng.choice([0.25, 0.5, 1.0, 2.0], J).tolist(),
            "memGib": rng.integers(1, 16, J).astype(float).tolist(),
            "priority": rng.integers(0, 3, J).astype(float).tolist(),
            "currentNode": np.where(rng.random(J) < 0.2, rng.integers(0, N, J), -1).tolist(),
        },
        "nodes": {"gpuFree": [4.0] * N, "memFreeGib": [64.0] * N},
    }
    out = json.loads(json.dumps(
        tb.solve_service_handler(json.loads(json.dumps(body)), device="cpu")
    ))
    assert set(out) == {"assignment", "placed", "solveMs", "policy", "rounds"}
    req = tb.SolveRequest(
        job_gpu=np.asarray(body["jobs"]["gpu"], np.float32),
        job_mem_gib=np.asarray(body["jobs"]["memGib"], np.float32),
        job_priority=np.asarray(body["jobs"]["priority"], np.float32),
        job_current_node=np.asarray(body["jobs"]["currentNode"], np.int32),
        node_gpu_free=np.full(N, 4.0, np.float32),
        node_mem_free_gib=np.full(N, 64.0, np.float32),
    )
    node, rounds = jax_packed_solve(req)
    assert out["assignment"] == node.tolist()
    assert out["rounds"] == rounds and out["placed"] == int((node >= 0).sum())


@pytest.mark.parametrize(
    "body,msg",
    [([], "JSON object"), ({"jobs": [1], "nodes": {}}, "JSON objects"),
     ({"jobs": {}, "nodes": {}}, "jobs.gpu")],
)
def test_solve_service_handler_rejects_bad_bodies(body, msg):
    with pytest.raises(ValueError, match=msg):
        tb.solve_service_handler(body, device="cpu")


def test_backend_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.TorchBackend()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.get_backend("jax-greedy")


def test_get_backend_registry():
    a = tb.get_backend("jax-greedy", "cpu")
    assert a is tb.get_backend(tb.SchedulerPolicy.JAX_GREEDY, "cpu")
    assert isinstance(tb.get_backend("native-greedy"), tb.NativeGreedyBackend)
    with pytest.raises(ValueError):
        tb.get_backend("not-a-policy", "cpu")
    with pytest.raises(ValueError):
        tb.TorchBackend(tb.SchedulerPolicy.NATIVE_GREEDY, device="cpu")


def test_auction_policy_falls_back_or_raises():
    """An unsuitable auction request falls back to greedy (as JaxBackend
    does); a suitable one is solved by the auction, equal to the
    reference's packed auction solve."""
    backend = tb.TorchBackend(tb.SchedulerPolicy.JAX_AUCTION, device="cpu")
    res = backend.solve(make_request(200, 20, 4))
    assert res.policy == "jax-greedy" and res.extras["auction_fallback"] == 1.0
    whole = tb.SolveRequest(
        job_gpu=np.full(8, 8.0, np.float32), job_mem_gib=np.ones(8, np.float32),
        node_gpu_free=np.full(8, 8.0, np.float32),
        node_mem_free_gib=np.full(8, 64.0, np.float32),
    )
    res = backend.solve(whole)
    from kubeinfer_tpu.solver.problem import pack_problem_arrays

    buf, _, _, J, N = pack_problem_arrays(**whole.__dict__)
    ref = jb._packed_solver()(
        buf, J=J, N=N, policy="jax-auction", accel=reference_accel(J, N),
        seeded=False,
    )
    np.testing.assert_array_equal(res.assignment, np.asarray(ref.node)[:8])
    assert res.rounds == int(ref.rounds) and res.placed == 8
    assert res.policy == "jax-auction" and "auction_fallback" not in res.extras


def test_descending_perm_and_incumbents_match():
    rng = np.random.default_rng(0)
    for pr in (rng.integers(0, 8, 500).astype(np.float32),
               rng.random(300).astype(np.float32),
               np.array([1.0, np.nan, 2.0, np.inf], np.float32)):
        np.testing.assert_array_equal(
            tb._descending_stable_perm(pr), jb._descending_stable_perm(pr)
        )
    for cur in (None, np.array([-1, -1]), np.array([-1, 3])):
        assert tb.request_has_incumbents(cur) == jb.request_has_incumbents(cur)
    req = make_request(50, 60, 1)
    assert tb.auction_suitable(req) == jb.auction_suitable(req)


def test_native_backend_matches_reference_native():
    req = make_request(400, 30, 5, gang_frac=0.2)
    ours = tb.NativeGreedyBackend().solve(req)
    ref = jb.NativeGreedyBackend().solve(jb.SolveRequest(**req.__dict__))
    np.testing.assert_array_equal(ours.assignment, ref.assignment)
    assert ours.placed == ref.placed


def test_import_loads_no_jax_and_no_reference_module():
    code = (
        "import sys, kubeinfer_tpu_torch, kubeinfer_tpu_torch.solver, "
        "kubeinfer_tpu_torch.scheduler, kubeinfer_tpu_torch.native, "
        "kubeinfer_tpu_torch._build\n"
        "from kubeinfer_tpu_torch.inference import batching, config, "
        "engine, flash_attention, kv_blocks, model, prng, server, "
        "sharding, stepper, weights\n"
        "import kubeinfer_tpu_torch.api, kubeinfer_tpu_torch.controller, "
        "kubeinfer_tpu_torch.controlplane.httpstore, "
        "kubeinfer_tpu_torch.controlplane.replica, "
        "kubeinfer_tpu_torch.coordination, kubeinfer_tpu_torch.disagg, "
        "kubeinfer_tpu_torch.manager, "
        "kubeinfer_tpu_torch.manager.__main__, kubeinfer_tpu_torch.metrics, "
        "kubeinfer_tpu_torch.observability, "
        "kubeinfer_tpu_torch.observability.slo, "
        "kubeinfer_tpu_torch.observability.stepprof, "
        "kubeinfer_tpu_torch.observability.flightrecorder, "
        "kubeinfer_tpu_torch.resilience.faultpoints, "
        "kubeinfer_tpu_torch.router.scoring, kubeinfer_tpu_torch.utils, "
        "kubeinfer_tpu_torch.utils.httpbase, kubeinfer_tpu_torch.agent, "
        "kubeinfer_tpu_torch.agent.__main__, kubeinfer_tpu_torch.ctl, "
        "kubeinfer_tpu_torch.inference.checkpoint, "
        "kubeinfer_tpu_torch.router, kubeinfer_tpu_torch.router.core, "
        "kubeinfer_tpu_torch.router.server, "
        "kubeinfer_tpu_torch.router.__main__, "
        "kubeinfer_tpu_torch.observability.loadgen, "
        "kubeinfer_tpu_torch.observability.fleetview, "
        "kubeinfer_tpu_torch.observability.__main__\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'kubeinfer_tpu', 'ml_dtypes', 'safetensors')]\n"
        "print(','.join(bad))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    assert out.stdout.strip() == ""


def _imported_names(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(REPO)),
)
def test_source_imports_stay_in_the_port(path):
    for name in _imported_names(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "kubeinfer_tpu", "ml_dtypes",
                           "safetensors"), (
            f"{path.name} imports {name}"
        )
