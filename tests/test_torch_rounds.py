"""The port's pipelined round loop against the JAX package's.

Four layers, on the same seeded numpy inputs:

- the plain round ops (``kubeinfer_tpu_torch.solver.kernels``:
  ``fence_minrank``, ``round_bids``, ``dense_accept``) against their jnp
  twins in ``kubeinfer_tpu.solver.core``, bitwise, at N in {64, 128,
  256} and an odd N, so every group rule of the bid runs;
- the same plain ops against the Pallas kernels they stand in for
  (``fence_minrank_pallas``, ``bid_reduce_pallas``,
  ``accept_phase_pallas``) in interpret mode, bitwise, J-tiled too;
- the walks of the fence and bid kernels (``fence_walk``, ``bid_walk``):
  the plain versions over only what each kernel reads equal the full ones
  bitwise, and the bid's column rule gives the reference's tile activity;
- the whole solve, ``solve_greedy(accel="pallas", device="cpu")`` against
  ``solve_greedy(accel="jnp")``, on cases mirroring the reference's
  ``TestGreedySmall``, ``TestGang``, ``TestChurnStability``,
  ``TestGreedyRandom`` and ``TestPriorityGating``: the same node, placed,
  rounds, gpu_free and mem_free.

Tolerance: none. The demands are dyadic (integers, halves, quarters), so
every sum is exact in any order; the bid arithmetic has no multiply-add
that XLA could contract.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.solver import core as jc
from kubeinfer_tpu.solver import pallas_kernels as pk
from kubeinfer_tpu.solver.problem import JobRow, NodeRow, encode_problem
from kubeinfer_tpu.solver.problem import encode_problem_arrays
from kubeinfer_tpu_torch.solver import core as tc
from kubeinfer_tpu_torch.solver import kernels as tk
from kubeinfer_tpu_torch.solver.problem import problem_from_arrays

RANK_INF = tk.RANK_INF


def round_inputs(seed, N, J):
    """One round's inputs: a cost field, live capacities (a few invalid
    nodes folded to -1), dyadic demands, fence ranks with RANK_INF rows
    (placed or invalid jobs), incumbents, and accept keys that embed the
    job index."""
    rng = np.random.default_rng(seed)
    S = rng.uniform(-3.0, 14.0, (N, J)).astype(np.float32)
    u = rng.uniform(0.0, 1.5, N).astype(np.float32)
    gf = rng.integers(0, 24, N).astype(np.float32)
    gf[rng.random(N) < 0.05] = -1.0
    mf = rng.integers(16, 160, N).astype(np.float32)
    d = rng.choice([0.5, 1.0, 2.0, 4.0, 7.0], J).astype(np.float32)
    md = rng.integers(1, 64, J).astype(np.float32)
    rank = rng.integers(0, 4, J).astype(np.float32)
    rank[rng.random(J) < 0.3] = RANK_INF
    cur = np.where(rng.random(J) < 0.3, rng.integers(0, N, J), -1).astype(np.int32)
    bits = max((J - 1).bit_length(), 1)
    key = (
        (rank.clip(0, 3).astype(np.int32) << (bits + 4))
        | ((15 - 2 * d.astype(np.int32).clip(0, 7)) << bits)
        | np.arange(J, dtype=np.int32)
    ).astype(np.int32)
    return dict(S=S, u=u, gf=gf, mf=mf, d=d, md=md, rank=rank, cur=cur, key=key)


def quant(N):
    bits, q_lo, q_scale, q_max = tc.quant_constants(N, tc.ScoreWeights())
    return dict(q_lo=q_lo, q_scale=q_scale, q_max=q_max, node_idx_bits=bits)


def T(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    want = np.asarray(want)
    have = got.numpy()
    assert have.dtype == want.dtype
    assert have.tobytes() == want.tobytes()


def choices(seed, N, J):
    """Bids concentrated on few nodes (contention), plus the N sentinel."""
    rng = np.random.default_rng(100 + seed)
    hot = rng.integers(0, N, max(N // 4, 1))
    c = np.where(rng.random(J) < 0.6, rng.choice(hot, J), rng.integers(0, N, J))
    return np.where(rng.random(J) < 0.2, N, c).astype(np.int32)


SHAPES = [(64, 192), (128, 192), (256, 128), (63, 96)]


@pytest.mark.parametrize("N,J", SHAPES)
def test_fence_minrank_bitwise(N, J):
    x = round_inputs(N + J, N, J)
    want = jc._fence_minrank(*(jnp.asarray(x[k]) for k in ("gf", "mf", "d", "md", "rank")))
    got = tk.fence_minrank(*(T(x[k]) for k in ("gf", "mf", "d", "md", "rank")))
    same(got, want)
    assert (got.numpy() < RANK_INF).any() and (got.numpy() == RANK_INF).any()


@pytest.mark.parametrize("N,J", SHAPES)
def test_round_bids_bitwise(N, J):
    x = round_inputs(N + J, N, J)
    q = quant(N)
    minrank = tk.fence_minrank(*(T(x[k]) for k in ("gf", "mf", "d", "md", "rank")))
    args = ("S", "u", "gf", "mf", "d", "md", "rank")
    prim, alt = jc._round_bids_jnp(
        *(jnp.asarray(x[k]) for k in args), jnp.asarray(minrank.numpy()),
        jnp.asarray(x["cur"]), N, q["q_lo"], q["q_scale"], q["q_max"],
        q["node_idx_bits"],
    )
    got_p, got_a = tk.round_bids(
        *(T(x[k]) for k in args), minrank, T(x["cur"]), **q
    )
    same(got_p, prim)
    same(got_a, alt)
    big = 0x7FFFFFFF
    assert (got_p.numpy() != big).any() and (got_p.numpy() == big).any()
    assert (got_a.numpy() != big).any()


def test_bid_group_rule():
    assert [tk.bid_group_size(n) for n in (128, 24576, 64, 62, 63)] == [16, 16, 32, 31, 1]


@pytest.mark.parametrize("N,J", SHAPES)
def test_dense_accept_bitwise(N, J):
    x = round_inputs(N + J, N, J)
    ch = choices(N, N, J)
    args = ("key", "d", "md", "gf", "mf")
    want = jc._dense_accept(jnp.asarray(ch), *(jnp.asarray(x[k]) for k in args), N)
    got = tk.dense_accept(T(ch), *(T(x[k]) for k in args))
    for g, w in zip(got, want):
        same(g, w)
    acc = got[0].numpy()
    assert acc.any() and not acc[ch == N].any()
    # some nodes accept all their bidders, some only the winner
    assert (~acc[ch < N]).any()


def pallas_case(seed, N, J, monkeypatch, tile_j):
    if tile_j:
        monkeypatch.setattr(pk, "MAX_TILE_J", tile_j)
        assert pk._tile_j(J) == tile_j
    x = round_inputs(seed, N, J)
    if tile_j:  # the last J tile holds only placed jobs: skipped
        x["rank"][-tile_j:] = RANK_INF
    minrank = tk.fence_minrank(*(T(x[k]) for k in ("gf", "mf", "d", "md", "rank")))
    # core.py:726-731, the activity rule the Pallas kernels skip tiles by
    finite = minrank < RANK_INF * 0.5
    max_mr = torch.where(finite, minrank, -1.0).max()
    active = (T(x["rank"]) < RANK_INF * 0.5) & (
        (T(x["rank"]) <= max_mr) | (T(x["cur"]) >= 0)
    )
    alias, act = pk.tile_activity(jnp.asarray(active.numpy()), J)
    return x, minrank, alias, act


PALLAS = [(128, 256, None), (256, 256, None), (128, 384, 128)]


@pytest.mark.parametrize("N,J,tile_j", PALLAS)
def test_fence_matches_interpret_kernel(N, J, tile_j, monkeypatch):
    x, minrank, _, _ = pallas_case(3, N, J, monkeypatch, tile_j)
    _, act = pk.tile_activity(jnp.asarray(x["rank"] < RANK_INF * 0.5), J)
    want = pk.fence_minrank_pallas(
        *(jnp.asarray(x[k]) for k in ("gf", "mf", "d", "md", "rank")), act,
        interpret=True,
    )
    same(minrank, want)


@pytest.mark.parametrize("N,J,tile_j", PALLAS)
def test_bid_matches_interpret_kernel(N, J, tile_j, monkeypatch):
    x, minrank, alias, act = pallas_case(4, N, J, monkeypatch, tile_j)
    q = quant(N)
    args = ("S", "u", "gf", "mf", "d", "md", "rank")
    want = pk.bid_reduce_pallas(
        *(jnp.asarray(x[k]) for k in args), jnp.asarray(minrank.numpy()),
        jnp.asarray(x["cur"]), alias, act, interpret=True, **q,
    )
    got = tk.round_bids(*(T(x[k]) for k in args), minrank, T(x["cur"]), **q)
    same(got[0], want[0])
    same(got[1], want[1])
    assert (np.asarray(act) == 0).any() == bool(tile_j)


@pytest.mark.parametrize("N,J,tile_j", PALLAS)
def test_accept_matches_interpret_kernel(N, J, tile_j, monkeypatch):
    x, _, _, _ = pallas_case(5, N, J, monkeypatch, tile_j)
    ch = choices(5, N, J)
    if tile_j:
        ch[-tile_j:] = N
    _, act = pk.tile_activity(jnp.asarray(ch < N), J)
    args = ("key", "d", "md", "gf", "mf")
    want = pk.accept_phase_pallas(
        jnp.asarray(ch), *(jnp.asarray(x[k]) for k in args), act,
        interpret=True,
    )
    got = tk.dense_accept(T(ch), *(T(x[k]) for k in args))
    for g, w in zip(got, want):
        same(g, w)



# --- the walks of the fence and bid kernels ----------------------------------


def walk_case(case, N, J):
    """``round_inputs`` with the variants the kernels' skips must hold
    on: ranks sorted ascending (the solver's order), every job placed, no
    node with a finite fence minimum, and incumbents whose rank is above
    every node's minimum (their column bids at home only)."""
    x = round_inputs(N * 7 + J, N, J)
    if case == "sorted":
        x["rank"] = np.sort(x["rank"])
    elif case == "placed":
        x["rank"][:] = RANK_INF
    elif case == "no_finite":
        x["gf"][:] = -1.0
    elif case == "home_above":
        inc = x["cur"] >= 0
        x["rank"] = np.where(inc, 3.0, 0.0).astype(np.float32)
        x["rank"][np.random.default_rng(N).random(J) < 0.1] = RANK_INF
    return x


WALK_SHAPES = SHAPES + [(62, 80), (1152, 96), (1100, 64)]
WALK_CASES = ["random", "sorted", "placed", "no_finite", "home_above"]


def allowed_pairs(t, minrank):
    """``round_bids``' allowed mask: the pairs whose bid is not BIG."""
    N = t["gf"].shape[0]
    n = torch.arange(N, dtype=torch.int32)[:, None]
    return (
        tk._feasible(t["gf"], t["mf"], t["d"], t["md"])
        & ((t["rank"][None, :] <= minrank[:, None]) | (t["cur"][None, :] == n))
        & (t["rank"][None, :] < RANK_INF * 0.5)
    )


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("N,J", WALK_SHAPES)
def test_bid_walk_is_exact(N, J, case):
    """The bid kernel reads S only at the pairs ``bid_walk`` keeps: every
    allowed pair is kept, so ``round_bids`` over the kept pairs alone (S
    poisoned elsewhere) equals the full ``round_bids`` bitwise, and the
    kernel's counts are the kept pairs'."""
    x = walk_case(case, N, J)
    t = {k: T(v) for k, v in x.items()}
    q = quant(N)
    mr = tk.fence_minrank(t["gf"], t["mf"], t["d"], t["md"], t["rank"])
    walk, home, entries, walks = tk.bid_walk(t["rank"], mr, t["cur"])
    chunk = torch.arange(N) // tk.BID_CHUNK
    n = torch.arange(N, dtype=torch.int32)[:, None]
    kept = walk[chunk] | (home[chunk] & (t["cur"][None, :] == n))
    assert not (allowed_pairs(t, mr) & ~kept).any()
    assert entries == int(kept.sum())
    tiles = -(-J // tk.BID_COLS)
    assert walks == sum(
        bool(walk[c, i * tk.BID_COLS:(i + 1) * tk.BID_COLS].any())
        for c in range(walk.shape[0]) for i in range(tiles))
    poisoned = torch.where(kept, t["S"], float("-inf"))
    args = ("u", "gf", "mf", "d", "md", "rank")
    want = tk.round_bids(t["S"], *(t[k] for k in args), mr, t["cur"], **q)
    got = tk.round_bids(poisoned, *(t[k] for k in args), mr, t["cur"], **q)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if case == "placed":
        assert entries == 0
    if case in ("placed", "no_finite"):
        assert (want[0] == 0x7FFFFFFF).all()
    if case == "home_above":
        assert home.any() and (want[0] != 0x7FFFFFFF).any()
    if case == "sorted" and N >= 128:
        assert entries < N * int((t["rank"] < RANK_INF * 0.5).sum())


def fence_kept(visits, N, J):
    """[N, J] bool: the (node, job) pairs of the chunks each node's warp
    sweeps."""
    n = torch.arange(N)
    warp = (n // tk.FENCE_BLOCK_NODES) * 8 + (n % 256) // 32
    j = torch.arange(J)
    split, chunk = j // tk.FENCE_JOBS, (j % tk.FENCE_JOBS) // tk.FENCE_CHUNK
    return visits[split[None, :], warp[:, None], chunk[None, :]]


@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("N,J", SHAPES + [(600, 4200)])
def test_fence_walk_is_exact(N, J, case):
    """The fence kernel's warps sweep only the chunks ``fence_walk``
    names; the minimum over those chunks alone equals ``fence_minrank``
    bitwise."""
    x = walk_case(case, N, J)
    t = {k: T(v) for k, v in x.items()}
    fargs = (t["gf"], t["mf"], t["d"], t["md"], t["rank"])
    want = tk.fence_minrank(*fargs)
    visits = tk.fence_walk(*fargs)
    feas = tk._feasible(t["gf"], t["mf"], t["d"], t["md"])
    got = torch.where(feas & fence_kept(visits, N, J), t["rank"][None, :],
                      RANK_INF).amin(dim=1)
    assert torch.equal(got, want)
    if case in ("placed", "no_finite"):
        assert not visits.any()
    if case == "sorted":
        assert 0 < int(visits.sum()) < visits.numel()


@pytest.mark.parametrize("N,J,tile_j", [(128, 192, None), (256, 384, 128),
                                        (1152, 384, 128), (63, 96, None)])
@pytest.mark.parametrize("case", ["random", "sorted", "home_above"])
def test_bid_column_rule_is_the_references(N, J, tile_j, case, monkeypatch):
    """A column takes part in the bid kernel's walk (in some chunk, or at
    its incumbent's node) exactly where core.py:729-731's ``active_j``
    holds, so ``pk.tile_activity`` gives the same ``act`` on both."""
    if tile_j:
        monkeypatch.setattr(pk, "MAX_TILE_J", tile_j)
    x = walk_case(case, N, J)
    t = {k: T(v) for k, v in x.items()}
    mr = tk.fence_minrank(t["gf"], t["mf"], t["d"], t["md"], t["rank"])
    walk, home, _, _ = tk.bid_walk(t["rank"], mr, t["cur"])
    mine = (walk | home).any(dim=0)
    finite = mr < RANK_INF * 0.5
    max_mr = torch.where(finite, mr, -1.0).max()
    ref = (t["rank"] < RANK_INF * 0.5) & (
        (t["rank"] <= max_mr) | (t["cur"] >= 0))
    assert torch.equal(mine, ref)
    got = pk.tile_activity(jnp.asarray(mine.numpy()), J)[1]
    want = pk.tile_activity(jnp.asarray(ref.numpy()), J)[1]
    assert np.array_equal(np.asarray(got), np.asarray(want))


# --- the whole solve ---------------------------------------------------------


def to_port(p):
    def arrays(obj):
        return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)}

    return problem_from_arrays(arrays(p.jobs), arrays(p.nodes), device="cpu")[0]


def compare(p, weights=jc.ScoreWeights(), seeded=True, max_rounds=64):
    """Port (pipelined loop, plain ops) vs the reference's jnp loop: every
    output identical."""
    ref = jc.solve_greedy(
        p, weights, max_rounds=max_rounds, accel="jnp", seeded=seeded
    )
    tw = tc.ScoreWeights(**dataclasses.asdict(weights))
    got = tc.solve_greedy(
        to_port(p), tw, max_rounds=max_rounds, seeded=seeded, device="cpu",
        accel="pallas",
    )
    same(got.node, ref.node)
    same(got.gpu_free, ref.gpu_free)
    same(got.mem_free, ref.mem_free)
    assert int(got.rounds) == int(ref.rounds)
    assert int(got.placed) == int(ref.placed)
    return got


J_ = JobRow
N_ = NodeRow
SMALL = {  # TestGreedySmall
    "cache_affinity": (
        [J_(gpu=1, mem_gib=10, model="llama")],
        [N_(gpu_free=4, mem_free_gib=100), N_(gpu_free=4, mem_free_gib=100, cached_models=["llama"])],
    ),
    "large_not_stranded": (
        [J_(gpu=2, mem_gib=8), J_(gpu=4, mem_gib=16), J_(gpu=1, mem_gib=4), J_(gpu=8, mem_gib=32)],
        [N_(gpu_free=8, mem_free_gib=64) for _ in range(2)],
    ),
    "infeasible": ([J_(gpu=16, mem_gib=10)], [N_(gpu_free=8, mem_free_gib=100)]),
    "contention": (
        [J_(gpu=2, mem_gib=1) for _ in range(4)],
        [N_(gpu_free=4, mem_free_gib=10) for _ in range(2)],
    ),
    "priority_contested": (
        [J_(gpu=1, priority=0), J_(gpu=1, priority=10)],
        [N_(gpu_free=1, mem_free_gib=10)],
    ),
    "hysteresis": (
        [J_(gpu=2, mem_gib=1, current_node=0)],
        [N_(gpu_free=4, mem_free_gib=10), N_(gpu_free=2, mem_free_gib=10)],
    ),
    "preemption": (
        [J_(gpu=1, priority=0, current_node=0), J_(gpu=1, priority=100)],
        [N_(gpu_free=1, mem_free_gib=10)],
    ),
}
GANG = {  # TestGang
    "incomplete_unwound": (
        [J_(gpu=2, gang=7) for _ in range(3)],
        [N_(gpu_free=2, mem_free_gib=10) for _ in range(2)],
    ),
    "complete_placed": (
        [J_(gpu=2, gang=3) for _ in range(2)],
        [N_(gpu_free=2, mem_free_gib=10) for _ in range(2)],
    ),
    "distinct_large_ids": (
        [J_(gpu=1, gang=70), J_(gpu=1, gang=70), J_(gpu=16, gang=100)],
        [N_(gpu_free=4, mem_free_gib=10)],
    ),
    "fill_drains_freed_node": (
        [J_(gpu=40, gang=5), J_(gpu=40, gang=5)] + [J_(gpu=1) for _ in range(50)],
        [N_(gpu_free=40, mem_free_gib=4096), N_(gpu_free=0, mem_free_gib=4096)],
    ),
    "capacity_freed": (
        [J_(gpu=2, gang=0) for _ in range(3)],
        [N_(gpu_free=2, mem_free_gib=10) for _ in range(2)],
    ),
}


@pytest.mark.parametrize("name", list(SMALL) + list(GANG))
def test_solve_matches_jnp_small_and_gang(name):
    jobs, nodes = {**SMALL, **GANG}[name]
    p, _ = encode_problem(jobs, nodes)
    got = compare(p)
    if name == "fill_drains_freed_node":
        assert (got.node.numpy()[:2] == -1).all()
        assert (got.node.numpy()[2:52] >= 0).sum() == 40


def test_solve_matches_jnp_best_fit_no_noise():
    p, _ = encode_problem(
        [J_(gpu=2, mem_gib=10)],
        [N_(gpu_free=8, mem_free_gib=100), N_(gpu_free=2, mem_free_gib=100)],
    )
    assert int(compare(p, jc.ScoreWeights(noise=0.0)).node[0]) == 1


def test_solve_matches_jnp_under_churn():
    """TestChurnStability: a solve, 10% churn, a seeded re-solve."""
    rng = np.random.default_rng(11)
    J, N = 600, 64
    kw = dict(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
    )
    first = compare(encode_problem_arrays(**kw))
    current = first.node.numpy()[:J].copy()
    departed = rng.random(J) < 0.1
    current[departed] = -1
    kw["job_gpu"][departed] = rng.integers(1, 8, departed.sum())
    kw["job_priority"][departed] = rng.integers(0, 8, departed.sum())
    second = compare(encode_problem_arrays(**kw, job_current_node=current))
    new = second.node.numpy()[:J]
    assert (new[~departed] != current[~departed]).mean() < 0.02


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("jn", [(40, 10), (200, 30)])
def test_solve_matches_jnp_random(seed, jn):
    """TestGreedyRandom, with memory on a quarter-GiB grid (dyadic)."""
    J, N = jn
    rng = np.random.default_rng(seed)
    jobs = [
        J_(
            gpu=float(rng.choice([0.5, 1, 2, 4])),
            mem_gib=float(np.round(rng.uniform(1, 40) * 4) / 4),
            priority=float(rng.integers(0, 5)),
            model=f"m{rng.integers(0, 8)}",
        )
        for _ in range(J)
    ]
    nodes = [
        N_(
            gpu_free=float(rng.choice([4, 8, 16])),
            mem_free_gib=float(np.round(rng.uniform(50, 200) * 4) / 4),
            topology=int(rng.integers(0, 4)),
            cached_models=[f"m{m}" for m in rng.choice(8, size=2, replace=False)],
        )
        for _ in range(N)
    ]
    p, _ = encode_problem(jobs, nodes)
    assert int(compare(p).placed) > 0


def test_solve_matches_jnp_priority_gating():
    """TestPriorityGating, both regressions."""
    p = encode_problem_arrays(
        job_gpu=np.array([6, 6, 6, 6, 4, 4, 4], np.float32),
        job_mem_gib=np.zeros(7, np.float32),
        job_priority=np.array([100, 100, 100, 100, 0, 0, 0], np.float32),
        node_gpu_free=np.full(4, 8.0, np.float32),
        node_mem_free_gib=np.full(4, 64.0, np.float32),
    )
    nodes = compare(p).node.numpy()
    assert (nodes[:4] >= 0).all() and (nodes[4:] == -1).all()
    cached = np.zeros((2, 4), bool)
    cached[0, 1] = cached[1, 2] = True
    p = encode_problem_arrays(
        job_gpu=np.array([6, 6, 4, 1, 1], np.float32),
        job_mem_gib=np.zeros(5, np.float32),
        job_priority=np.array([300, 300, 200, 100, 0], np.float32),
        job_model=np.array([1, 1, 2, 3, 3], np.int32),
        node_gpu_free=np.full(2, 8.0, np.float32),
        node_mem_free_gib=np.full(2, 64.0, np.float32),
        node_cached=cached,
    )
    nodes = compare(p).node.numpy()
    assert (nodes[:2] >= 0).all() and nodes[2] == -1 and (nodes[3:5] >= 0).all()


def test_solve_matches_jnp_when_the_budget_caps():
    """A round budget of 2 caps the main loop with jobs still placeable:
    the fill runs with its own absolute cap, in both packages."""
    rng = np.random.default_rng(21)
    J, N = 300, 20
    p = encode_problem_arrays(
        job_gpu=rng.choice([1.0, 2.0], J).astype(np.float32),
        job_mem_gib=rng.integers(1, 8, J).astype(np.float32),
        job_priority=rng.integers(0, 3, J).astype(np.float32),
        node_gpu_free=np.full(N, 16.0, np.float32),
        node_mem_free_gib=np.full(N, 256.0, np.float32),
    )
    got = compare(p, seeded=False, max_rounds=2)
    assert int(got.rounds) > 2


# --- routing -----------------------------------------------------------------


@pytest.mark.parametrize("J,N", [(384, 64), (64, 1024), (1024, 128), (768, 64)])
def test_auto_routes_as_the_reference(J, N, monkeypatch):
    """``auto`` resolves as kubeinfer_tpu/solver/core.py:457-461 does on
    its accelerator, and the solve runs the loop it resolved to. The
    reference's "jnp" (unaligned axes) and "pallas" (aligned, no window)
    are both the pipelined loop, which the port names "pallas"."""
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        ref = jc._resolve_accel("auto", J, N)
    want = "mega" if ref == "mega" else "pallas"
    assert tc.resolve_accel("auto", J, N) == want
    calls = []
    real = tc.run_rounds
    monkeypatch.setattr(
        tc, "run_rounds", lambda *a, **k: calls.append(1) or real(*a, **k)
    )
    rng = np.random.default_rng(J + N)
    n_jobs, n_nodes = J - 3, N - 5
    p = encode_problem_arrays(
        job_gpu=rng.integers(1, 4, n_jobs).astype(np.float32),
        job_mem_gib=rng.integers(1, 8, n_jobs).astype(np.float32),
        node_gpu_free=np.full(n_nodes, 8.0, np.float32),
        node_mem_free_gib=np.full(n_nodes, 64.0, np.float32),
    )
    assert p.jobs.valid.shape[0] == J and p.nodes.valid.shape[0] == N
    tc.solve_greedy(to_port(p), seeded=False, device="cpu")
    assert bool(calls) == (want == "pallas")


def test_unknown_accel_raises():
    p = encode_problem_arrays(
        job_gpu=np.ones(4, np.float32), job_mem_gib=np.ones(4, np.float32),
        node_gpu_free=np.full(2, 4.0, np.float32),
        node_mem_free_gib=np.full(2, 8.0, np.float32),
    )
    for bad in ("jnp", "interpret", "mega-jnp", ""):
        with pytest.raises(ValueError, match="unknown accel"):
            tc.solve_greedy(to_port(p), device="cpu", accel=bad)


# --- the wrappers ------------------------------------------------------------


def test_wrappers_on_cpu_are_the_plain_versions():
    N, J = 128, 192
    x = round_inputs(9, N, J)
    t = {k: T(v) for k, v in x.items()}
    q = quant(N)
    counts = (tk.fence.launches, tk.bid.launches, tk.accept.launches)
    mr = tk.fence(t["gf"], t["mf"], t["d"], t["md"], t["rank"])
    assert torch.equal(mr, tk.fence_minrank(t["gf"], t["mf"], t["d"], t["md"], t["rank"]))
    bargs = (t["S"], t["u"], t["gf"], t["mf"], t["d"], t["md"], t["rank"], mr, t["cur"])
    for a, b in zip(tk.bid(*bargs, **q), tk.round_bids(*bargs, **q)):
        assert torch.equal(a, b)
    aargs = (T(choices(9, N, J)), t["key"], t["d"], t["md"], t["gf"], t["mf"])
    for a, b in zip(tk.accept(*aargs), tk.dense_accept(*aargs)):
        assert torch.equal(a, b)
    assert (tk.fence.launches, tk.bid.launches, tk.accept.launches) == counts


def test_wrappers_refuse_other_devices():
    x = {k: T(v).to("meta") for k, v in round_inputs(9, 64, 64).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        tk.fence(x["gf"], x["mf"], x["d"], x["md"], x["rank"])
    with pytest.raises(ValueError, match="unsupported device"):
        tk.accept(x["cur"], x["key"], x["d"], x["md"], x["gf"], x["mf"])


@pytest.mark.cuda
@pytest.mark.parametrize("N,J", [(64, 768), (128, 384), (63, 96)])
def test_round_kernels_match_plain_on_card(N, J):
    """Each round kernel against its plain version on the same card
    tensors, one launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    x = {k: T(v).cuda() for k, v in round_inputs(N * J, N, J).items()}
    q = quant(N)
    before = (tk.fence.launches, tk.bid.launches, tk.accept.launches)
    fargs = (x["gf"], x["mf"], x["d"], x["md"], x["rank"])
    mr = tk.fence(*fargs)
    assert torch.equal(mr, tk.fence_minrank(*fargs))
    bargs = (x["S"], x["u"], x["gf"], x["mf"], x["d"], x["md"], x["rank"], mr, x["cur"])
    for a, b in zip(tk.bid(*bargs, **q), tk.round_bids(*bargs, **q)):
        assert torch.equal(a, b)
    aargs = (T(choices(1, N, J)).cuda(), x["key"], x["d"], x["md"], x["gf"], x["mf"])
    for a, b in zip(tk.accept(*aargs), tk.dense_accept(*aargs)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    after = (tk.fence.launches, tk.bid.launches, tk.accept.launches)
    assert after == tuple(c + 1 for c in before)


@pytest.mark.cuda
@pytest.mark.parametrize("case", WALK_CASES)
@pytest.mark.parametrize("N,J", [(62, 80), (63, 96), (1152, 384),
                                 (3000, 200), (2048, 4200)])
def test_round_kernel_walks_on_card(N, J, case):
    """The fence and bid kernels against their plain versions on several
    node splits (N up to 3000: six bid chunks), all-BIG columns, home-only
    incumbents and the group sizes 31, 1 and 16; repeated launches
    bitwise equal, and each kernel's own walk count equal to its mirror's
    (``fence_walk``, ``bid_walk``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    x = {k: T(v).cuda() for k, v in walk_case(case, N, J).items()}
    q = quant(N)
    fargs = (x["gf"], x["mf"], x["d"], x["md"], x["rank"])
    bargs = ("S", "u", "gf", "mf", "d", "md", "rank")
    tk.fence.walk_counter = torch.zeros(1, dtype=torch.int64, device="cuda")
    tk.bid.walk_counter = torch.zeros(2, dtype=torch.int64, device="cuda")
    try:
        mr = tk.fence(*fargs)
        assert torch.equal(mr, tk.fence_minrank(*fargs))
        assert int(tk.fence.walk_counter) == int(tk.fence_walk(*fargs).sum())
        got = tk.bid(*(x[k] for k in bargs), mr, x["cur"], **q)
        want = tk.round_bids(*(x[k] for k in bargs), mr, x["cur"], **q)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        _, _, entries, walks = tk.bid_walk(x["rank"], mr, x["cur"])
        assert tk.bid.walk_counter.tolist() == [entries, walks]
        for _ in range(3):  # the tickets are left zero for the next launch
            assert torch.equal(tk.fence(*fargs), mr)
            again = tk.bid(*(x[k] for k in bargs), mr, x["cur"], **q)
            for a, b in zip(again, want):
                assert torch.equal(a, b)
        torch.cuda.synchronize()
    finally:
        tk.fence.walk_counter = tk.bid.walk_counter = None


# --- the accept workspace ----------------------------------------------------


@pytest.mark.parametrize("name", ["contention", "fill_drains_freed_node",
                                  "random_200x30"])
def test_run_rounds_owns_one_accept_workspace(name, monkeypatch):
    """``run_rounds`` passes one ``AcceptWorkspace`` of its own to every
    accept call of a solve; the solve equals the reference's (``compare``)
    and the same solve with accept called without a workspace."""
    if name == "random_200x30":
        rng = np.random.default_rng(5)
        p = encode_problem_arrays(
            job_gpu=rng.choice([0.5, 1.0, 2.0], 200).astype(np.float32),
            job_mem_gib=rng.integers(1, 16, 200).astype(np.float32),
            job_priority=rng.integers(0, 4, 200).astype(np.float32),
            node_gpu_free=np.full(30, 8.0, np.float32),
            node_mem_free_gib=np.full(30, 64.0, np.float32),
        )
    else:
        p, _ = encode_problem(*{**SMALL, **GANG}[name])
    seen = []
    real = tk.accept

    def with_ws(*a):
        seen.append(a[6])
        return real(*a)

    monkeypatch.setattr(tk, "accept", with_ws)
    got = compare(p)
    assert seen and all(isinstance(w, tk.AcceptWorkspace) for w in seen)
    # one workspace a run_rounds call: the main loop's, then the fill's
    assert len({id(w) for w in seen}) <= 2
    assert seen[0].buf.shape == (6 * p.nodes.valid.shape[0],)
    monkeypatch.setattr(tk, "accept", lambda *a: real(*a[:6]))
    again = tc.solve_greedy(to_port(p), seeded=True, device="cpu",
                            accel="pallas")
    for a, b in ((got.node, again.node), (got.gpu_free, again.gpu_free),
                 (got.mem_free, again.mem_free)):
        assert torch.equal(a, b)
    assert int(got.rounds) == int(again.rounds)


def test_dense_accept_ignores_the_workspace():
    N, J = 63, 97
    x = {k: T(v) for k, v in round_inputs(4, N, J).items()}
    args = (T(choices(4, N, J)), x["key"], x["d"], x["md"], x["gf"], x["mf"])
    ws = tk.AcceptWorkspace(N, "cpu")
    for a, b in zip(tk.accept(*args, ws), tk.dense_accept(*args)):
        assert torch.equal(a, b)
    assert ws.half == 0 and not ws.buf.any()


@pytest.mark.cuda
@pytest.mark.parametrize("N,J", [(63, 97), (1001, 3003)])
def test_accept_reuses_one_workspace_on_card(N, J):
    """One workspace over five accept launches of different bids at odd N
    and J: each bitwise equal to ``dense_accept``; after each, the half the
    next launch takes is zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    x = {k: T(v).cuda() for k, v in round_inputs(N + J, N, J).items()}
    ws = tk.AcceptWorkspace(N, torch.device("cuda"))
    before = tk.accept.launches
    for call in range(5):
        args = (T(choices(call, N, J)).cuda(), x["key"], x["d"], x["md"],
                x["gf"], x["mf"])
        got = tk.accept(*args, ws)
        for a, b in zip(got, tk.dense_accept(*args)):
            assert torch.equal(a, b)
        torch.cuda.synchronize()
        assert ws.half == (call + 1) % 2
        assert not ws.buf.view(2, -1)[ws.half].any()
    assert tk.accept.launches == before + 5
