"""The port's ``jax-auction`` solve against the JAX package's.

Three layers, on the same seeded numpy inputs:

- the loop: ``kernels.auction_rounds`` against ``core._auction_loop_jnp``
  (and the Pallas ``auction_solve`` in interpret mode), bitwise, iteration
  count included, on the SAME benefit and tie-break arrays fed to both;
- the benefit field and the tie-break: exactly equal on dyadic requests
  (GPU capacities 16/64, memory 64/128/512 GiB, integer demands), where
  every term of the fit cost is exact, so a multiply-add that XLA's CPU
  backend contracts rounds the same as PyTorch's separate steps;
- the whole solve, ``solve_auction(device="cpu")`` against the JAX
  ``solve_auction(accel=reference_accel(J, N))``, so that the greedy fill
  takes the same main loop in both: node, placed, rounds, gpu_free and
  mem_free equal, on dyadic requests.

Tolerance: none anywhere; ``test_benefit_field_close_off_the_grid`` states
the one place where a non-dyadic input is compared, and why within 1e-6.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.scheduler import backends as jb
from kubeinfer_tpu.solver import core as jc
from kubeinfer_tpu.solver import pallas_kernels as pk
from kubeinfer_tpu.solver.problem import JobRow, NodeRow, encode_problem
from kubeinfer_tpu.solver.problem import encode_problem_arrays
from kubeinfer_tpu_torch.scheduler import backends as tb
from kubeinfer_tpu_torch.solver import core as tc
from kubeinfer_tpu_torch.solver import kernels as tk
from kubeinfer_tpu_torch.solver.problem import problem_from_arrays

CPU = torch.device("cpu")


def to_port(p):
    def arrays(obj):
        return {
            f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }

    return problem_from_arrays(arrays(p.jobs), arrays(p.nodes), device=CPU)[0]


def reference_accel(J, N):
    """The reference's accelerator routing with the jnp twins standing in
    (tests/test_torch_backend.py:reference_accel)."""
    if J % 128 == 0 and N % 128 == 0 and pk.mega_window(N, J) is not None:
        return "mega-jnp"
    return "jnp"


# --- the loop ----------------------------------------------------------------


def random_field(seed, J, N):
    """TestAuctionFusedParity._rand_instance."""
    rng = np.random.default_rng(seed)
    benefit = rng.normal(0.0, 3.0, (J, N)).astype(np.float32)
    infeas = rng.random((J, N)) < 0.25
    benefit = np.where(infeas, -float(jc.INFEASIBLE), benefit).astype(np.float32)
    return benefit, rng.random(J) < 0.9


def identical_field():
    """256 identical whole-node jobs on 256 identical nodes."""
    J = N = 256
    return np.full((J, N), -0.875, np.float32), np.ones(J, bool)


def pocket_field():
    """Model-pocket overflow: 25 jobs whose model is cached on 20 of 64
    nodes (a 5.0 cache gap): a price war that ends on the stale exit."""
    J, N = 25, 64
    rng = np.random.default_rng(11)
    fit = (rng.integers(0, 8, (J, N)) / 8.0).astype(np.float32)
    benefit = -(5.0 + fit)
    benefit[:, :20] = -fit[:, :20]
    return benefit.astype(np.float32), np.ones(J, bool)


FIELDS = {
    **{f"fused_{s}_{J}x{N}": (lambda s=s, J=J, N=N: random_field(s, J, N), 512)
       for s, J, N in [(0, 96, 128), (1, 128, 128), (2, 256, 384), (3, 8, 128)]},
    "identical_256": (identical_field, 512),
    "pocket_stale_exit": (pocket_field, 512),
    "max_iters_4": (lambda: random_field(1, 128, 128), 4),
    "unaligned_50x64": (lambda: random_field(4, 50, 64), 512),
}


def run_both(benefit, valid, max_iters):
    J, N = benefit.shape
    tiebreak = np.array(jc._auction_tiebreak(J, N))
    want = jc._auction_loop_jnp(
        jnp.asarray(benefit), jnp.asarray(tiebreak), jnp.asarray(valid),
        jnp.float32(0.01), max_iters,
    )
    active, near = [], []
    got = tk.auction_rounds(
        torch.from_numpy(benefit), torch.from_numpy(tiebreak),
        torch.from_numpy(valid), 0.01, max_iters=max_iters, active_rows=active,
        near_entries=near,
    )
    return want, got, (active, near), tiebreak


@pytest.mark.parametrize("case", list(FIELDS))
def test_auction_rounds_bitwise(case):
    make, max_iters = FIELDS[case]
    benefit, valid = make()
    (w_asg, w_it), (g_asg, g_it), (active, near), _ = run_both(
        benefit, valid, max_iters)
    np.testing.assert_array_equal(g_asg.numpy(), np.asarray(w_asg))
    assert int(g_it) == int(w_it)
    assert len(active) == int(g_it) and active[0] == int(valid.sum())
    # every bidding row has at least its best entry near; no more than its
    # whole row
    N = benefit.shape[1]
    assert len(near) == int(g_it)
    assert all(0 <= n <= a * N for n, a in zip(near, active))
    # the first iteration, at price 0, by hand
    best = benefit.max(axis=1)
    bids = valid & (best > np.float32(-0.5e9))
    near0 = benefit >= (best - np.float32(jc._TIE_TOL))[:, None]
    assert near[0] == int(near0[bids].sum()) >= 1
    if case == "identical_256":
        assert (g_asg.numpy() >= 0).all() and int(g_it) < 20
    if case == "pocket_stale_exit":
        # the loop left on the stale counter, with jobs still bidding
        assert jc._STALE_ITERS <= int(g_it) < 512
        assert (g_asg.numpy() < 0).any()
    if case == "max_iters_4":
        assert int(g_it) == 4


def test_auction_rounds_match_the_pallas_kernel():
    benefit, valid = random_field(3, 8, 128)
    (_, _), (g_asg, g_it), _, tiebreak = run_both(benefit, valid, 512)
    p_asg, p_it = pk.auction_solve(
        jnp.asarray(benefit), jnp.asarray(tiebreak), jnp.asarray(valid),
        jnp.float32(0.01), max_iters=512, stale_iters=jc._STALE_ITERS,
        tie_tol=jc._TIE_TOL, neg=-float(jc.INFEASIBLE), interpret=True,
    )
    np.testing.assert_array_equal(g_asg.numpy(), np.asarray(p_asg))
    assert int(g_it) == int(p_it)


def test_constants_pinned():
    assert tk.INFEASIBLE == float(jc.INFEASIBLE)
    assert tk.TIE_TOL == jc._TIE_TOL and tk.STALE_ITERS == jc._STALE_ITERS
    assert tc.INFEASIBLE == tk.INFEASIBLE


# --- the benefit field -------------------------------------------------------


def dyadic_request(J, N, seed, gang_frac=0.0, inc_frac=0.0, whole=True,
                   gpu_caps=(16.0, 64.0)):
    """Requests on a dyadic grid (capacities 16/64 GPU and 64/128/512 GiB,
    integer demands; 16 GPUs a job when ``whole``): every fit term is
    exact."""
    rng = np.random.default_rng(seed)
    gpu_cap = rng.choice(gpu_caps, N).astype(np.float32)
    mem_cap = rng.choice([64.0, 128.0, 512.0], N).astype(np.float32)
    return dict(
        job_gpu=(np.full(J, 16.0) if whole else rng.integers(1, 9, J)).astype(np.float32),
        job_mem_gib=rng.integers(8, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 4, J).astype(np.float32),
        job_gang=np.where(
            rng.random(J) < gang_frac, rng.integers(0, max(J // 4, 1), J), -1
        ).astype(np.int32),
        job_model=rng.integers(0, 16, J).astype(np.int32),
        job_current_node=np.where(
            rng.random(J) < inc_frac, rng.integers(0, N, J), -1
        ).astype(np.int32),
        node_gpu_free=gpu_cap,
        node_mem_free_gib=mem_cap,
        node_gpu_capacity=gpu_cap,
        node_mem_capacity_gib=mem_cap,
        node_topology=rng.integers(0, 4, N).astype(np.int32),
        node_cached=rng.random((N, 16)) < 0.1,
    )


def reference_benefit(p, w=jc.ScoreWeights()):
    """kubeinfer_tpu/solver/core.py:1346-1359, outside the jit."""
    jobs, nodes = p.jobs, p.nodes
    feas = (
        (jobs.gpu_demand[:, None] <= nodes.gpu_free[None, :] + jc._EPS)
        & (jobs.mem_demand[:, None] <= nodes.mem_free[None, :] + jc._EPS)
        & nodes.valid[None, :] & jobs.valid[:, None]
    )
    inv_g = 1.0 / jnp.maximum(nodes.gpu_capacity, 1.0)
    inv_m = 1.0 / jnp.maximum(nodes.mem_capacity, 1.0)
    fit = jc._fit_cost(nodes.gpu_free, nodes.mem_free, p, w, inv_g, inv_m)
    return np.asarray(
        jnp.where(feas, -(jc._static_cost_t(p, w).T + fit), -jc.INFEASIBLE)
    )


@pytest.mark.parametrize("J,N,seed,inc", [(64, 64, 0, 0.0), (200, 256, 1, 0.3)])
def test_benefit_field_and_tiebreak_exact(J, N, seed, inc):
    p = encode_problem_arrays(**dyadic_request(J, N, seed, inc_frac=inc, whole=False))
    tp = to_port(p)
    got = tc.auction_benefit(tp, tc.ScoreWeights())
    np.testing.assert_array_equal(got.numpy(), reference_benefit(p))
    assert got.is_contiguous()
    Jp, Np = tp.jobs.valid.shape[0], tp.nodes.valid.shape[0]
    np.testing.assert_array_equal(
        tc.auction_tiebreak(Jp, Np, CPU).numpy(),
        np.asarray(jc._auction_tiebreak(Jp, Np)),
    )


def test_benefit_field_close_off_the_grid():
    """Capacities and demands off the dyadic grid: XLA may contract the
    fit term's multiply-adds, which PyTorch rounds step by step, so the
    fields agree within 1e-6 relative (a few f32 ulps), not bitwise."""
    rng = np.random.default_rng(5)
    J, N = 96, 80
    p = encode_problem_arrays(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(1, 40, J).astype(np.float32),
        job_model=rng.integers(0, 16, J).astype(np.int32),
        node_gpu_free=rng.integers(6, 24, N).astype(np.float32),
        node_mem_free_gib=rng.integers(48, 300, N).astype(np.float32),
        node_cached=rng.random((N, 16)) < 0.2,
    )
    got = tc.auction_benefit(to_port(p), tc.ScoreWeights()).numpy()
    np.testing.assert_allclose(got, reference_benefit(p), rtol=1e-6, atol=0)


# --- the whole solve ---------------------------------------------------------


def gang_fill_problem():
    """TestAuctionGangFill: a gang of 3 on 2 nodes unwinds; the filler
    must take a freed node."""
    jobs = [JobRow(gpu=8, mem_gib=32, gang=1) for _ in range(3)]
    jobs.append(JobRow(gpu=8, mem_gib=32))
    nodes = [NodeRow(gpu_free=8, mem_free_gib=64) for _ in range(2)]
    return encode_problem(jobs, nodes)[0]


def gang_fuzz_problem(seed):
    """TestAuctionGangFill.test_fill_property_fuzz at 24 x 16."""
    r = np.random.default_rng(seed)
    J, N = 24, 16
    gang = np.where(r.random(J) < 0.5, r.integers(0, 4, J), -1).astype(np.int32)
    return encode_problem_arrays(
        job_gpu=np.full(J, 8.0, np.float32),
        job_mem_gib=r.integers(8, 33, J).astype(np.float32),
        job_gang=gang,
        node_gpu_free=np.full(N, 8.0, np.float32),
        node_mem_free_gib=np.full(N, 64.0, np.float32),
    )


SOLVES = {
    "whole_fresh_200x256": lambda: encode_problem_arrays(
        **dyadic_request(200, 256, 2, gpu_caps=(16.0,))),
    "gang_of_3_on_2": gang_fill_problem,
    "gang_fuzz_24x16": lambda: gang_fuzz_problem(3),
    "gangs_128x128_mega_fill": lambda: encode_problem_arrays(
        **dyadic_request(128, 128, 4, gang_frac=0.25)),
    "incumbents_100x128": lambda: encode_problem_arrays(
        **dyadic_request(100, 128, 6, gang_frac=0.1, inc_frac=0.4)),
}


@pytest.mark.parametrize("case", list(SOLVES))
def test_solve_auction_matches_reference(case, monkeypatch):
    p = SOLVES[case]()
    J, N = p.jobs.valid.shape[0], p.nodes.valid.shape[0]
    ref = jc.solve_auction(p, accel=reference_accel(J, N))
    fills = []
    orig = tc.solve_greedy
    monkeypatch.setattr(
        tc, "solve_greedy", lambda *a, **kw: fills.append(1) or orig(*a, **kw)
    )
    got = tc.solve(to_port(p), policy="jax-auction", device="cpu")
    np.testing.assert_array_equal(got.node.numpy(), np.asarray(ref.node))
    assert int(got.placed) == int(ref.placed)
    assert int(got.rounds) == int(ref.rounds)
    np.testing.assert_array_equal(got.gpu_free.numpy(), np.asarray(ref.gpu_free))
    np.testing.assert_array_equal(got.mem_free.numpy(), np.asarray(ref.mem_free))
    node = got.node.numpy()
    placed = node[node >= 0]
    if case == "gang_of_3_on_2":
        assert (node[:3] == -1).all() and node[3] >= 0
    if case == "whole_fresh_200x256":
        assert int(got.placed) == 200 and len(set(placed.tolist())) == 200
    # every case but the fresh whole-node one leaves a job to the fill
    assert bool(fills) == (case != "whole_fresh_200x256")


def test_solve_auction_fill_routes_through_mega(monkeypatch):
    """At 128 x 128 the fill is a mega solve, as ``resolve_accel`` routes
    it; an unknown accel fails before any work."""
    calls = []
    orig = tk.mega_solve

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    spy.launches = 0
    monkeypatch.setattr(tk, "mega_solve", spy)
    got = tc.solve_auction(to_port(SOLVES["gangs_128x128_mega_fill"]()), device="cpu")
    assert calls and int(got.placed) > 0
    with pytest.raises(ValueError, match="unknown accel"):
        tc.solve_auction(to_port(gang_fill_problem()), device="cpu", accel="jnp")


# --- the backend -------------------------------------------------------------


def whole_node_request(J, N, seed):
    rng = np.random.default_rng(seed)
    return tb.SolveRequest(
        job_gpu=np.full(J, 64.0, np.float32),
        job_mem_gib=rng.integers(64, 512, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        job_model=rng.integers(0, 256, J).astype(np.int32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=(rng.random((N, 256)) < 0.02).astype(np.uint8),
    )


def jax_packed_auction(req):
    from kubeinfer_tpu.solver.problem import pack_problem_arrays

    perm = None
    pr = req.job_priority
    if pr is not None and np.any(pr[1:] > pr[:-1]):
        perm = jb._descending_stable_perm(pr)
    buf, _, _, J, N = pack_problem_arrays(**req.__dict__, job_perm=perm)
    out = jb._packed_solver()(
        buf, J=J, N=N, policy="jax-auction", accel=reference_accel(J, N),
        seeded=False,
    )
    node = np.asarray(out.node)[: req.num_jobs]
    if perm is not None:
        un = np.empty_like(node)
        un[perm] = node
        node = un
    return node, int(out.rounds)


@pytest.mark.parametrize("J,N,seed", [(100, 120, 3), (32, 64, 4)])
def test_backend_auction_matches_jax_packed(J, N, seed):
    """Priority-sorted, packed, solved and un-permuted as JaxBackend."""
    req = whole_node_request(J, N, seed)
    assert tb.auction_suitable(req)
    res = tb.TorchBackend(tb.SchedulerPolicy.JAX_AUCTION, device="cpu").solve(req)
    node, rounds = jax_packed_auction(req)
    np.testing.assert_array_equal(res.assignment, node)
    assert res.rounds == rounds and res.placed == J
    assert res.policy == "jax-auction" and "auction_fallback" not in res.extras


def test_backend_auction_fallback_still_reported():
    req = whole_node_request(40, 30, 5)  # more jobs than nodes
    res = tb.TorchBackend(tb.SchedulerPolicy.JAX_AUCTION, device="cpu").solve(req)
    assert res.policy == "jax-greedy" and res.extras["auction_fallback"] == 1.0


@pytest.mark.parametrize("policy", ["jax-auction", "jax-greedy"])
def test_warmup_reaches_its_own_solve(monkeypatch, policy):
    """The auction's warm-up request is one the auction accepts, so it
    builds the auction kernel and not only the greedy ones."""
    called = []
    for name in ("solve_auction", "solve_greedy"):
        orig = getattr(tc, name)
        monkeypatch.setattr(
            tc, name,
            lambda *a, _n=name, _o=orig, **kw: called.append(_n) or _o(*a, **kw),
        )
    tb.TorchBackend(policy, device="cpu").warmup(num_jobs=96, num_nodes=64)
    want = policy.replace("jax-", "solve_")
    assert called and called[0] == want


# --- the wrapper -------------------------------------------------------------


def test_auction_wrapper_on_cpu_is_the_plain_version():
    benefit, valid = random_field(0, 96, 128)
    t = [torch.from_numpy(benefit),
         tc.auction_tiebreak(96, 128, CPU), torch.from_numpy(valid)]
    before = tk.auction_solve.launches
    a, i = tk.auction_solve(*t, 0.01, max_iters=512)
    b, j = tk.auction_rounds(*t, 0.01, max_iters=512)
    assert torch.equal(a, b) and int(i) == int(j)
    assert tk.auction_solve.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tk.auction_solve(*(x.to("meta") for x in t), 0.01, max_iters=8)


@pytest.mark.cuda
@pytest.mark.parametrize("J,N,seed", [
    (64, 64, 7), (96, 128, 0), (256, 384, 2),
    # both sides of auction_plan's line, N not a multiple of 128 (odd too)
    (100, 1000, 1), (50, 63, 2), (300, 4100, 4), (40, 16400, 5),
])
def test_auction_kernel_matches_plain_on_card(J, N, seed):
    """The kernel ``auction_plan`` routes to against its plain version on
    the same card tensors, three launches back to back, bitwise (assigned,
    iterations), with the kernel's own walk count equal to
    ``auction_walk``'s."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    dev = torch.device("cuda")
    benefit, valid = random_field(seed, J, N)
    t = [torch.from_numpy(benefit).to(dev), tc.auction_tiebreak(J, N, dev),
         torch.from_numpy(valid).to(dev)]
    plan = tk.auction_plan(J, N, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.route == ("wide" if N > 16384 else "shared")
    want_a, want_i = tk.auction_rounds(*t, 0.01, max_iters=512)
    mirror = tk.auction_walk(*t, 0.01, max_iters=512, plan=plan)
    before = tk.auction_solve.launches
    try:
        for _ in range(3):
            tk.auction_solve.walk_counter = torch.zeros(
                3, dtype=torch.int64, device=dev)
            a, i = tk.auction_solve(*t, 0.01, max_iters=512)
            torch.cuda.synchronize()
            assert torch.equal(a, want_a) and int(i) == int(want_i)
            assert tk.auction_solve.walk_counter.tolist() == mirror.tolist()
    finally:
        tk.auction_solve.walk_counter = None
    assert tk.auction_solve.launches == before + 3


# --- the launch plan and the walk mirror --------------------------------------


def test_auction_plan_covers_every_bucket_pair():
    """Every (J, N) bucket pair up to 16384 x 16384: the shared-state kernel
    where a row fits a block (N <= 512 x 32) and the state fits its shared
    memory (8 bytes a node and a job), on min(SMs, J) blocks; the
    two-barrier kernel ("wide") past that line."""
    from kubeinfer_tpu_torch.solver.problem import BUCKETS

    sizes = [b for b in BUCKETS if b <= 16384]
    routes = {}
    for sms in (132, 114):
        for J in sizes:
            for N in sizes:
                plan = tk.auction_plan(J, N, sms)
                state = 8 * (N + J)
                fits = N <= 16384 and state <= tk.AUCTION_SMEM_LIMIT
                assert plan.route == ("shared" if fits else "wide"), (J, N)
                assert plan.threads == tk.AUCTION_THREADS == 512
                if fits:
                    assert plan.blocks == min(sms, J)
                    assert plan.smem == state <= 232448 - 1024
                else:
                    assert plan.blocks == 2 * sms and plan.smem == 0
                routes[J, N] = plan.route
    # where the line lies: the chip_smoke fields, and the state's size
    assert routes[1024, 1024] == routes[4096, 4096] == "shared"
    assert routes[16384, 12288] == routes[12288, 16384] == "shared"
    assert routes[16384, 16384] == "wide"
    assert tk.auction_plan(1024, 24576, 132).route == "wide"
    assert tk.auction_plan(64, 16385, 132).route == "wide"


@pytest.mark.parametrize("active,N,blocks", [
    (1, 1024, 132), (21, 1024, 132), (132, 1024, 132), (133, 1024, 132),
    (1000, 1024, 132), (4096, 4096, 132), (81, 4096, 132), (5, 16384, 3),
    (700, 100, 2), (9000, 64, 132), (64, 64, 64),
])
def test_auction_deal_walks_every_row_once(active, N, blocks):
    """The shared kernel's deal: every active row to exactly one group; a
    whole block a row while the rows are no more than the blocks; groups of
    at least the threads that hold a row (32 values a thread), and of the
    most threads that still give every row a group of its own."""
    deal = tk.auction_deal(active, N, blocks)
    walked = sorted(i for pos in deal for i in pos)
    assert walked == list(range(active))
    groups = len(deal)
    G = blocks * 512 // groups
    gmin = next(g for g in (32, 64, 128, 256, 512) if g * 32 >= N)
    assert G in (32, 64, 128, 256, 512) and G >= gmin
    if active <= blocks:
        assert G == 512
    if G > gmin:
        assert groups >= active
    if G < 512:
        assert groups // 2 < active


@pytest.mark.parametrize("case", ["fused_0_96x128", "identical_256",
                                  "pocket_stale_exit", "unaligned_50x64"])
@pytest.mark.parametrize("sms", [132, 3])
def test_auction_walk_mirror(case, sms):
    """``auction_walk``'s rows (summed over the groups of each iteration's
    deal) and tie-break entries equal ``auction_rounds``' active rows and
    near entries; one grid barrier an iteration on the shared route, one a
    launch and two an iteration on the two-barrier kernel."""
    make, max_iters = FIELDS[case]
    benefit, valid = make()
    J, N = benefit.shape
    args = (torch.from_numpy(benefit), tc.auction_tiebreak(J, N, CPU),
            torch.from_numpy(valid), 0.01)
    active, near = [], []
    _, it = tk.auction_rounds(*args, max_iters=max_iters, active_rows=active,
                              near_entries=near)
    plan = tk.auction_plan(J, N, sms)
    assert plan.route == "shared"
    got = tk.auction_walk(*args, max_iters=max_iters, plan=plan)
    assert got.tolist() == [sum(active), sum(near), int(it)]
    wide = tk.AuctionPlan("wide", 2 * sms, 512, 0)
    got = tk.auction_walk(*args, max_iters=max_iters, plan=wide)
    assert got.tolist() == [sum(active), sum(near), 1 + 2 * int(it)]
