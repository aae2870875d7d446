"""The port's sharded solve against the JAX package's ``solve_sharded``.

The same seeded problems go through ``kubeinfer_tpu.solver.sharded.
solve_sharded`` on the 8 virtual CPU devices (``tests/conftest.py``) and
``kubeinfer_tpu_torch.solver.sharded.solve_sharded`` on a mesh over
``["cpu"] * 8``, at meshes (8, 1), (4, 2) and (2, 4): the cases of
``tests/test_sharded.py`` and a seeded churn case with 30% incumbents
whose preemption repair reads a column of the sharded field. At N = 64
the mesh (2, 4) puts each node slice inside one bid group (16 nodes of a
32-node group).

Tolerance: none. ``node``, ``gpu_free``, ``mem_free``, ``rounds`` and
``placed`` are bitwise the reference's, and the port's own unsharded
``solve_greedy(accel="pallas")``'s. The node-slice combine of the bids is
also held bitwise to the whole field's ``round_bids`` on its own, at every
group rule.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from kubeinfer_tpu.solver import sharded as js  # noqa: E402
from kubeinfer_tpu.solver.problem import encode_problem_arrays  # noqa: E402
from kubeinfer_tpu_torch.solver import core as tc  # noqa: E402
from kubeinfer_tpu_torch.solver import kernels as tk  # noqa: E402
from kubeinfer_tpu_torch.solver import sharded as ts  # noqa: E402
from kubeinfer_tpu_torch.solver.problem import problem_from_arrays  # noqa: E402

CPU8 = ["cpu"] * 8
FIELDS = ("node", "gpu_free", "mem_free", "rounds", "placed")


def to_port(p):
    def arrays(obj):
        return {f.name: np.asarray(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}

    return problem_from_arrays(arrays(p.jobs), arrays(p.nodes),
                               device="cpu")[0]


def random_problem(J=500, N=64, seed=0):
    rng = np.random.default_rng(seed)
    return encode_problem_arrays(
        job_gpu=rng.integers(1, 4, J).astype(np.float32),
        job_mem_gib=rng.integers(1, 16, J).astype(np.float32),
        job_priority=rng.integers(0, 4, J).astype(np.float32),
        node_gpu_free=np.full(N, 32.0, np.float32),
        node_mem_free_gib=np.full(N, 256.0, np.float32),
    )


def oversubscribed():
    rng = np.random.default_rng(7)
    J, N = 400, 16
    return encode_problem_arrays(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(1, 8, J).astype(np.float32),
        node_gpu_free=np.full(N, 16.0, np.float32),
        node_mem_free_gib=np.full(N, 64.0, np.float32),
    )


def gang_problem():
    J = 200
    gang = np.full(J, -1, np.int32)
    gang[:8] = 5  # one infeasible gang (8 x 8 chips > any node)
    return encode_problem_arrays(
        job_gpu=np.concatenate([np.full(8, 8.0), np.ones(J - 8)]
                               ).astype(np.float32),
        job_mem_gib=np.ones(J, np.float32),
        job_gang=gang,
        job_priority=np.concatenate([np.zeros(8), np.full(J - 8, 5.0)]
                                    ).astype(np.float32),
        node_gpu_free=np.full(4, 8.0, np.float32),
        node_mem_free_gib=np.full(4, 64.0, np.float32),
    )


def churn_problem(seed=12, J=300, N=64):
    """30% incumbents on tight nodes, four priority classes, model
    affinity: seated low-priority incumbents squat capacity that
    higher-priority unplaced jobs need, so the preemption repair runs."""
    rng = np.random.default_rng(seed)
    return encode_problem_arrays(
        job_gpu=rng.integers(1, 7, J).astype(np.float32),
        job_mem_gib=rng.integers(1, 16, J).astype(np.float32),
        job_priority=rng.integers(0, 4, J).astype(np.float32),
        job_model=rng.integers(0, 8, J).astype(np.int32),
        job_current_node=np.where(rng.random(J) < 0.3,
                                  rng.integers(0, N, J), -1).astype(np.int32),
        node_gpu_free=rng.integers(4, 17, N).astype(np.float32),
        node_mem_free_gib=np.full(N, 128.0, np.float32),
        node_cached=rng.random((N, 8)) < 0.2,
    )


CASES = {
    "data_parallel_500x64": (lambda: random_problem(500, 64, 0), (8, 1)),
    "mesh_2d_300x64": (lambda: random_problem(300, 64, 3), (4, 2)),
    "oversubscribed_400x16": (oversubscribed, (8, 1)),
    "gang_200x4": (gang_problem, (8, 1)),
    "churn_300x64_inside_group": (churn_problem, (2, 4)),
    "churn_300x64_2d": (churn_problem, (4, 2)),
}


def assert_same(got, want):
    for k in FIELDS:
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.numpy().dtype == w.dtype, k
        assert g.numpy().tobytes() == w.tobytes(), k


@pytest.mark.parametrize("case", list(CASES))
def test_solve_sharded_matches_reference(case, monkeypatch):
    make, (ja, na) = CASES[case]
    p = make()
    want = js.solve_sharded(p, js.make_mesh(8, job_axis=ja, node_axis=na))
    columns = []
    real = ts.ShardedField.column
    monkeypatch.setattr(ts.ShardedField, "column",
                        lambda self, j: columns.append(int(j)) or real(self, j))
    mesh = ts.make_mesh(8, job_axis=ja, node_axis=na, devices=CPU8)
    got = ts.solve_sharded(to_port(p), mesh)
    assert_same(got, want)
    # and the port's own unsharded pipelined solve, bit for bit
    whole = tc.solve_greedy(to_port(p), device="cpu", accel="pallas")
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(whole, k)), k
    if case.startswith("churn"):
        assert columns, "the preemption repair never read a column"


def test_make_mesh_shapes():
    m = ts.make_mesh(8, devices=CPU8)
    assert m.devices.shape == (8, 1)
    assert m.axis_names == ("jobs", "nodes")
    m2 = ts.make_mesh(8, job_axis=4, node_axis=2, devices=CPU8)
    assert m2.devices.shape == (4, 2)
    assert (m2.owners == 0).all()
    with pytest.raises(ValueError):
        ts.make_mesh(8, job_axis=3, node_axis=2, devices=CPU8)
    with pytest.raises(ValueError, match="requested 9"):
        ts.make_mesh(9, devices=CPU8)


def test_shard_problem_places_axes():
    p = to_port(random_problem())
    J, N = p.jobs.valid.shape[0], p.nodes.valid.shape[0]
    sp = ts.shard_problem(p, ts.make_mesh(8, job_axis=4, node_axis=2,
                                          devices=CPU8))
    assert sorted(sp.pieces) == [(a, b) for a in range(4) for b in range(2)]
    for (a, b), piece in sp.pieces.items():
        assert piece.jobs.gpu_demand.shape == (J // 4,)
        assert piece.nodes.cached.shape == (N // 2, p.nodes.cached.shape[1])
        assert torch.equal(piece.jobs.priority, p.jobs.priority[sp.cols[a]])
        assert torch.equal(piece.nodes.gpu_free, p.nodes.gpu_free[sp.rows[b]])
    with pytest.raises(ValueError, match="equal"):
        ts.shard_problem(p, ts.make_mesh(3, devices=CPU8))


def test_sharded_blocks_are_the_whole_field():
    """Every block of the sharded S is the whole S's block, bitwise."""
    p = to_port(churn_problem())
    w = tc.ScoreWeights()
    whole = tc.cost_field(p, w)
    _, f = ts.sharded_field(p, ts.make_mesh(8, job_axis=2, node_axis=4,
                                            devices=CPU8), w)
    for (a, b), blk in f.S.blocks.items():
        assert torch.equal(blk, whole.S[f.S.rows[b], f.S.cols[a]])
    j = torch.tensor(77)
    assert torch.equal(f.column(j), whole.S[:, 77])


@pytest.mark.parametrize("N,slices", [(128, 2), (128, 16), (64, 2), (64, 4),
                                      (66, 2), (63, 3)])
def test_node_slice_combine_matches_whole(N, slices):
    """Bids per node slice (``group_size`` of the whole axis, offsets
    added) combined over the slices equal the whole field's bids: slices
    of whole groups (N=128 by 2, 64 by 2, 66 by 2 at 33-node groups, the
    odd N=63 by 3 at one-node groups) and slices inside a group (128 by
    16, 64 by 4)."""
    rng = np.random.default_rng(N + slices)
    J = 96
    S = torch.from_numpy(rng.uniform(-3, 14, (N, J)).astype(np.float32))
    u = torch.from_numpy(rng.uniform(0, 1.5, N).astype(np.float32))
    gf = torch.from_numpy(rng.integers(0, 24, N).astype(np.float32))
    mf = torch.from_numpy(rng.integers(16, 160, N).astype(np.float32))
    d = torch.from_numpy(rng.choice([0.5, 1.0, 2.0, 4.0], J).astype(np.float32))
    md = torch.from_numpy(rng.integers(1, 64, J).astype(np.float32))
    rank = torch.from_numpy(rng.integers(0, 4, J).astype(np.float32))
    cur = torch.from_numpy(np.where(rng.random(J) < 0.3, rng.integers(0, N, J),
                                    -1).astype(np.int32))
    mr = tk.fence_minrank(gf, mf, d, md, rank)
    bits, q_lo, q_scale, q_max = tc.quant_constants(N, tc.ScoreWeights())
    q = dict(q_lo=q_lo, q_scale=q_scale, q_max=q_max, node_idx_bits=bits)
    want = tk.round_bids(S, u, gf, mf, d, md, rank, mr, cur, **q)
    field = ts.ShardedField.__new__(ts.ShardedField)
    w = N // slices
    field.rows = [slice(i * w, (i + 1) * w) for i in range(slices)]
    field.home, field.group = torch.device("cpu"), tk.bid_group_size(N)
    pairs = [tk.round_bids(S[r], u[r], gf[r], mf[r], d, md, rank, mr[r],
                           cur - r.start, group_size=field.group, **q)
             for r in field.rows]
    got = field._combine(pairs, bits)
    for g, x in zip(got, want):
        assert torch.equal(g, x)


def test_uneven_group_split_raises():
    assert tk.slice_group_size(32, 16) == 16  # whole groups
    assert tk.slice_group_size(8, 16) == 8  # inside one group
    assert tk.slice_group_size(64, None) == 32  # the tensor's own rule
    with pytest.raises(ValueError, match="bid groups"):
        tk.slice_group_size(22, 33)


def test_sharded_auction_is_entry_13b():
    p = to_port(random_problem(64, 16))
    with pytest.raises(NotImplementedError, match="13b: the sharded auction"):
        ts.solve_sharded(p, ts.make_mesh(2, devices=CPU8),
                         policy="jax-auction")
    with pytest.raises(ValueError, match="unknown solver policy"):
        ts.solve_sharded(p, ts.make_mesh(2, devices=CPU8), policy="x")
