"""The port's problem encoding against the JAX package's.

Same numpy inputs (made from a seed) go through
``kubeinfer_tpu.solver.problem`` and ``kubeinfer_tpu_torch.solver.problem``:
the packed buffers must be byte-equal and the unpacked fields equal.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubeinfer_tpu.solver import problem as jp
from kubeinfer_tpu_torch.solver import problem as tp

CPU = torch.device("cpu")


def make_kwargs(J=50, N=10, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(1, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 5, J).astype(np.float32),
        job_gang=np.where(
            rng.random(J) < 0.3, rng.integers(0, 5, J), -1
        ).astype(np.int32),
        job_model=rng.integers(0, 300, J).astype(np.int32),
        job_current_node=np.where(
            rng.random(J) < 0.5, rng.integers(0, N, J), -1
        ).astype(np.int32),
        node_gpu_free=rng.integers(8, 64, N).astype(np.float32),
        node_mem_free_gib=rng.integers(64, 512, N).astype(np.float32),
        node_topology=rng.integers(0, 4, N).astype(np.int32),
        node_cached=(rng.random((N, 32)) < 0.2).astype(np.uint8),
    )


def fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("J,N,seed", [(50, 10, 3), (200, 16, 7), (700, 130, 1)])
def test_packed_buffer_byte_equal(J, N, seed, permuted):
    kw = make_kwargs(J, N, seed)
    if permuted:
        kw["job_perm"] = np.argsort(-kw["job_priority"], kind="stable")
    ref = jp.pack_problem_arrays(**kw)
    got = tp.pack_problem_arrays(**kw)
    assert ref[1:] == got[1:]
    assert ref[0].tobytes() == got[0].tobytes()


def test_packed_buffer_defaults_byte_equal():
    """Only the required fields: every default fill must match."""
    kw = make_kwargs(33, 5, 0)
    kw = {k: kw[k] for k in ("job_gpu", "job_mem_gib", "node_gpu_free",
                             "node_mem_free_gib")}
    assert (
        jp.pack_problem_arrays(**kw)[0].tobytes()
        == tp.pack_problem_arrays(**kw)[0].tobytes()
    )


@pytest.mark.parametrize("seed", [3, 4])
def test_unpack_fields_equal(seed):
    buf, _, _, J, N = jp.pack_problem_arrays(**make_kwargs(seed=seed))
    ref = jax.jit(jp.unpack_problem, static_argnames=("J", "N"))(buf, J=J, N=N)
    got = tp.unpack_problem(buf, J, N, CPU)
    for part in ("jobs", "nodes"):
        want, have = fields(getattr(ref, part)), fields(getattr(got, part))
        assert want.keys() == have.keys()
        for name in want:
            np.testing.assert_array_equal(
                have[name].numpy(), np.asarray(want[name]),
                err_msg=f"{part}.{name}",
            )
            assert have[name].numpy().dtype == np.asarray(want[name]).dtype


def test_problem_from_arrays_carries_state():
    """The carry-across function rebuilds the port's Problem from a JAX
    Problem's fields, and the weights from the JAX ScoreWeights."""
    from kubeinfer_tpu.solver.core import ScoreWeights as JaxWeights

    kw = make_kwargs(seed=5)
    ref = jp.encode_problem_arrays(**kw)
    buf, _, _, J, N = tp.pack_problem_arrays(**kw)
    unpacked = tp.unpack_problem(buf, J, N, CPU)
    got, w = tp.problem_from_arrays(
        {k: np.asarray(v) for k, v in fields(ref.jobs).items()},
        {k: np.asarray(v) for k, v in fields(ref.nodes).items()},
        JaxWeights(cache=3.0, noise=0.1),
        device=CPU,
    )
    assert (w.cache, w.noise, w.move) == (3.0, 0.1, 8.0)
    for part in ("jobs", "nodes"):
        for name, t in fields(getattr(got, part)).items():
            assert torch.equal(t, fields(getattr(unpacked, part))[name]), name


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000, 12288, 65536])
def test_bucket_size_matches(n):
    assert tp.bucket_size(n) == jp.bucket_size(n)
    assert tp.BUCKETS == jp.BUCKETS
    assert tp.MAX_MODELS == jp.MAX_MODELS and tp.GIB == jp.GIB


def test_bucket_size_overflow_raises():
    with pytest.raises(ValueError):
        tp.bucket_size(jp.BUCKETS[-1] + 1)


def test_densify_and_clamp_match():
    rng = np.random.default_rng(0)
    gang = np.where(rng.random(100) < 0.5, rng.integers(0, 10**6, 100), -1)
    np.testing.assert_array_equal(
        tp._densify_gangs(gang), jp._densify_gangs(gang)
    )
    jm = rng.integers(-5, 400, 100)
    np.testing.assert_array_equal(
        tp._clamp_model_ids(jm), jp._clamp_model_ids(jm)
    )
    assert tp._padded_sizes(100, 9, 3, 5) == jp._padded_sizes(100, 9, 3, 5)
