"""The port's greedy solve against the JAX package's mega path.

The same problems (made from a seed with numpy) go through
``kubeinfer_tpu.solver.core.solve_greedy(accel="mega-jnp")`` and
``kubeinfer_tpu_torch.solver.solve_greedy(device="cpu", accel="mega")``
(explicit, since ``auto`` takes the pipelined loop at unaligned shapes;
that loop is tested in ``test_torch_rounds.py``); the pieces
with a JAX counterpart (tie-noise hash, dense ranks, accept key, static
cost, gang repair) are checked bit for bit on their own.

Tolerance of the whole solve: the same ``node``, ``placed`` and
``rounds``. The one known source of a difference is XLA's CPU backend
contracting a multiply and an add of the bid quantization into one fused
op that PyTorch rounds twice; that can move a quantized bid by one step.
Only where a test shows that this happened on its input (``fma_moves``
> 0) may it fall back to the hard invariants plus ``placed`` within 1%.
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
from kubeinfer_tpu.solver.problem import encode_problem_arrays
from kubeinfer_tpu_torch.solver import core as tc
from kubeinfer_tpu_torch.solver import kernels as tk
from kubeinfer_tpu_torch.solver.problem import problem_from_arrays

CPU = torch.device("cpu")
PLACED_TOL = 0.01  # fallback only, see the module docstring


def to_port(p, weights=None):
    def arrays(obj):
        return {
            f.name: np.asarray(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        }

    return problem_from_arrays(arrays(p.jobs), arrays(p.nodes), weights, device=CPU)


def instance(seed, J=384, N=128, tight=False, gang_frac=0.0, inc_frac=0.0):
    """TestMegaSerializedGreedy._sorted_instance, with the gang and
    incumbent fractions as parameters."""
    rng = np.random.default_rng(seed)
    order = np.argsort(-rng.integers(0, 8, J).astype(np.float32), kind="stable")
    pr = rng.integers(0, 8, J).astype(np.float32)[order]
    kw = dict(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=pr,
        job_gang=np.where(
            rng.random(J) < gang_frac, rng.integers(0, 40, J), -1
        ).astype(np.int32),
        job_model=rng.integers(0, 16, J).astype(np.int32),
        job_current_node=np.where(
            rng.random(J) < inc_frac, rng.integers(0, N, J), -1
        ).astype(np.int32),
        node_gpu_free=(
            rng.integers(4, 17, N) if tight else np.full(N, 16)
        ).astype(np.float32),
        node_mem_free_gib=np.full(N, 128.0, np.float32),
        node_cached=(rng.random((N, 16)) < 0.1),
    )
    return encode_problem_arrays(**kw), kw


def fma_moves(tp_, weights):
    """How many quantized bids of the first round XLA's fused evaluation
    moves against the separately rounded one, on this problem's S."""
    f = tc.cost_field(tp_, weights)
    gf = torch.where(tp_.nodes.valid, tp_.nodes.gpu_free, -1.0)
    u = ((f.v_g * gf + f.v_m * tp_.nodes.mem_free) * f.q_scale).numpy()
    S = f.S.numpy()

    @jax.jit
    def fused(S, u):
        return jnp.clip((S - f.q_lo) * f.q_scale + u[:, None], 0.0, f.q_max).astype(jnp.int32)

    sq = (S - np.float32(f.q_lo)) * np.float32(f.q_scale)
    plain = np.clip(sq + u[:, None], 0.0, np.float32(f.q_max)).astype(np.int32)
    return int((np.asarray(fused(S, u)) != plain).sum())


def check_invariants(kw, node, gpu_free, mem_free):
    J, N = len(kw["job_gpu"]), len(kw["node_gpu_free"])
    a = node[:J]
    for n in range(N):
        assert kw["job_gpu"][a == n].sum() <= kw["node_gpu_free"][n] + 1e-3
        assert kw["job_mem_gib"][a == n].sum() <= kw["node_mem_free_gib"][n] + 1e-3
    gang = kw["job_gang"]
    for g in np.unique(gang[gang >= 0]):
        members = a[gang == g]
        assert (members >= 0).all() or (members < 0).all()
    for j in np.nonzero(a < 0)[0]:
        if gang[j] < 0:
            fits = (kw["job_gpu"][j] <= gpu_free[:N] + 1e-3) & (
                kw["job_mem_gib"][j] <= mem_free[:N] + 1e-3
            )
            assert not fits.any(), j


def compare_solves(p, kw, seeded, weights=jc.ScoreWeights()):
    ref = jc.solve_greedy(p, weights, accel="mega-jnp", seeded=seeded)
    tp_, tw = to_port(p, weights)
    got = tc.solve_greedy(tp_, tw, seeded=seeded, device="cpu", accel="mega")
    same = (
        np.array_equal(np.asarray(ref.node), got.node.numpy())
        and int(ref.placed) == int(got.placed)
        and int(ref.rounds) == int(got.rounds)
    )
    if not same:
        moves = fma_moves(tp_, tw)
        assert moves > 0, "solves differ and fused rounding does not explain it"
        check_invariants(kw, got.node.numpy(), got.gpu_free.numpy(),
                         got.mem_free.numpy())
        assert abs(int(got.placed) - int(ref.placed)) <= PLACED_TOL * int(ref.placed)
    else:
        np.testing.assert_array_equal(
            got.gpu_free.numpy(), np.asarray(ref.gpu_free)
        )
        np.testing.assert_array_equal(
            got.mem_free.numpy(), np.asarray(ref.mem_free)
        )
    return ref, got


FIXTURES = {
    "fresh": dict(),
    "tight": dict(tight=True),
    "gangs": dict(tight=True, gang_frac=0.2),
    "incumbents": dict(tight=True, gang_frac=0.2, inc_frac=0.3),
}


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("case", list(FIXTURES))
def test_whole_solve_matches_mega_jnp(case, seed):
    p, kw = instance(seed, **FIXTURES[case])
    compare_solves(p, kw, seeded=case == "incumbents")


@pytest.fixture
def small_windows(monkeypatch):
    """W=128 in both packages. The window width is read while JAX traces,
    so the jit caches are dropped on entry and on exit: a solve compiled
    for these shapes with the wide window must not be reused."""
    jax.clear_caches()
    monkeypatch.setattr(pk, "_MEGA_S_BYTES", 128 * 128 * 4)
    monkeypatch.setattr(tk, "_MEGA_S_BYTES", 128 * 128 * 4)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("seed", [2, 3])
def test_whole_solve_matches_multi_window(small_windows, seed):
    assert pk.mega_window(128, 384) == tk.mega_window(128, 384) == 128
    p, kw = instance(seed, **FIXTURES["incumbents"])
    compare_solves(p, kw, seeded=True)


def test_whole_solve_matches_other_weights():
    p, kw = instance(7, tight=True, gang_frac=0.1)
    w = jc.ScoreWeights(fit_gpu=2.0, cache=3.0, noise=0.0)
    compare_solves(p, kw, seeded=False, weights=w)


def test_preemption_repair_matches():
    """A low-priority incumbent squats the one node a top-priority arrival
    needs: the repair unseats it, in both packages."""
    kw = dict(
        job_gpu=np.array([8.0, 4.0, 4.0], np.float32),
        job_mem_gib=np.array([8.0, 4.0, 4.0], np.float32),
        job_priority=np.array([10.0, 5.0, 0.0], np.float32),
        job_gang=np.full(3, -1, np.int32),
        job_current_node=np.array([-1, 0, 0], np.int32),
        node_gpu_free=np.array([8.0, 4.0], np.float32),
        node_mem_free_gib=np.array([64.0, 64.0], np.float32),
    )
    p = encode_problem_arrays(**kw)
    ref, got = compare_solves(p, kw, seeded=True)
    assert got.node.numpy()[0] == 0


@pytest.mark.parametrize("N,J", [(128, 384), (64, 64), (1024, 256)])
def test_tie_noise_hash_bitwise(N, J):
    h = tc.tie_noise_hash(N, J, CPU).numpy()
    _n = jax.lax.broadcasted_iota(jnp.int32, (N, J), 0)
    _j = jax.lax.broadcasted_iota(jnp.int32, (N, J), 1)
    _h = _n * jnp.int32(-1640531527) + _j * jnp.int32(40503)
    _h = _h ^ (_h >> 13)
    _h = _h * jnp.int32(-1274126529)
    _h = _h ^ (_h >> 16)
    np.testing.assert_array_equal(h, np.asarray(_h))
    # the auction's tie-break is the same hash with the axes swapped
    np.testing.assert_array_equal(
        h & 0x7FFFFFFF, np.asarray(jc._auction_tiebreak(N, J))
    )


@pytest.mark.parametrize("seed", range(4))
def test_prank_bitwise(seed):
    rng = np.random.default_rng(seed)
    J = 200
    neg_p = rng.integers(-6, 0, J).astype(np.float32)
    neg_p[rng.random(J) < 0.1] = np.inf
    srt = np.sort(neg_p)
    for v in (srt, neg_p):
        np.testing.assert_array_equal(
            tc._prank_dense(torch.from_numpy(v)).numpy(),
            np.asarray(jc._prank_dense(jnp.asarray(v))),
        )
    np.testing.assert_array_equal(
        tc._prank_sorted(torch.from_numpy(srt)).numpy(),
        np.asarray(jc._prank_sorted(jnp.asarray(srt))),
    )


@pytest.mark.parametrize("J", [64, 384, 12288])
def test_accept_key_bitwise(J):
    rng = np.random.default_rng(J)
    prank = np.sort(rng.integers(0, 9, J)).astype(np.int32)
    d = rng.choice([0.25, 0.5, 1.0, 3.0, 7.0, 12.0], J).astype(np.float32)
    got = tc.accept_key(torch.from_numpy(prank), torch.from_numpy(d)).numpy()
    # core.py:620-629
    j_idx_bits = max((J - 1).bit_length(), 1)
    rank_bits = 31 - j_idx_bits - 4
    rank_c = jnp.clip(jnp.asarray(prank), 0, (1 << rank_bits) - 1)
    dmax = jnp.maximum(jnp.max(jnp.asarray(d)), 1.0)
    demand_q = jnp.clip(jnp.asarray(d) * (15.0 / dmax), 0, 15).astype(jnp.int32)
    want = (
        (rank_c << (4 + j_idx_bits))
        | ((15 - demand_q) << j_idx_bits)
        | jnp.arange(J, dtype=jnp.int32)
    )
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_static_cost_bitwise(seed):
    p, _ = instance(seed, inc_frac=0.3)
    tp_, tw = to_port(p)
    np.testing.assert_array_equal(
        tc._static_cost_t(tp_, tw).numpy(),
        np.asarray(jc._static_cost_t(p, jc.ScoreWeights())),
    )


def test_quant_constants_match():
    for w in (tc.ScoreWeights(), tc.ScoreWeights(noise=0.0, cache=2.5)):
        bits, q_lo, q_scale, q_max = tc.quant_constants(1024, w)
        assert bits == 10 and q_max == float((1 << 21) - 2)
        assert q_lo == -(w.fit_gpu + w.fit_mem) - 2.0 * max(w.noise, 1e-3)


@pytest.mark.parametrize("seed", range(4))
def test_gang_repair_bitwise(seed):
    p, kw = instance(seed, tight=True, gang_frac=0.4)
    rng = np.random.default_rng(50 + seed)
    J = len(kw["job_gpu"])
    asg = np.where(rng.random(384) < 0.7, rng.integers(0, 128, 384), -1)
    asg = np.where(np.arange(384) < J, asg, -1).astype(np.int32)
    ref = jc._gang_repair(p, jnp.asarray(asg))
    tp_, _ = to_port(p)
    got = tc._gang_repair(tp_, torch.from_numpy(asg))
    for r, g in zip(ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_no_mega_window_raises(monkeypatch):
    """With no mega window the solve no longer raises: ``auto`` takes the
    pipelined loop, equal to the reference's jnp loop. Only an explicit
    ``accel="mega"`` raises there."""
    monkeypatch.setattr(tk, "_MEGA_S_BYTES", 4)
    p, _ = instance(0, tight=True, gang_frac=0.2, inc_frac=0.3)
    tp_, tw = to_port(p)
    assert tk.mega_window(128, 384) is None
    ref = jc.solve_greedy(p, accel="jnp")
    got = tc.solve_greedy(tp_, tw, device="cpu")
    np.testing.assert_array_equal(got.node.numpy(), np.asarray(ref.node))
    assert int(got.rounds) == int(ref.rounds)
    assert int(got.placed) == int(ref.placed)
    np.testing.assert_array_equal(got.gpu_free.numpy(), np.asarray(ref.gpu_free))
    np.testing.assert_array_equal(got.mem_free.numpy(), np.asarray(ref.mem_free))
    with pytest.raises(ValueError, match="no mega window"):
        tc.solve_greedy(tp_, tw, device="cpu", accel="mega")


def test_auction_policy_not_ported():
    """Named for the stub it replaced: ``solve`` now dispatches
    ``jax-auction`` to ``solve_auction`` (equal to the reference's
    ``solve(policy="jax-auction")``), and still refuses the serial
    policy."""
    p, _ = instance(0, J=96, N=128)
    tp_, tw = to_port(p)
    got = tc.solve(tp_, policy="jax-auction", device="cpu")
    want = tc.solve_auction(tp_, tw, device="cpu")
    ref = jc.solve(p, policy="jax-auction", accel="jnp")
    for g, w in ((got.node, want.node), (got.rounds, want.rounds)):
        assert torch.equal(g, w)
    np.testing.assert_array_equal(got.node.numpy(), np.asarray(ref.node))
    assert int(got.rounds) == int(ref.rounds)
    with pytest.raises(ValueError, match="native-greedy"):
        tc.solve(tp_, policy="native-greedy", device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p, _ = instance(0)
    tp_, tw = to_port(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.solve_greedy(tp_, tw)
