"""The port's mega loop against the JAX package's.

``kubeinfer_tpu_torch.solver.kernels.mega_rounds`` (the plain version of
the CUDA kernel) must be bitwise equal to ``mega_rounds_jnp`` and to
``mega_solve_pallas`` in interpret mode. The inputs are dyadic so that no
rounding can differ between the frameworks (XLA may fuse a multiply and
an add that PyTorch rounds separately): a power-of-two ``q_scale``, a
dyadic ``q_lo``, S on a 2^-8 grid, integer demands and capacities, and
fit-pressure weights of 2^-6 / 2^-10. Every sum is then exact in any order.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.solver import pallas_kernels as pk
from kubeinfer_tpu_torch.solver import kernels as tk
from kubeinfer_tpu_torch.solver.core import resolve_accel
from kubeinfer_tpu_torch.solver.problem import BUCKETS


def dyadic_inputs(seed, N=128, J=384, seeded=False, may_frac=1.0):
    rng = np.random.default_rng(seed)
    node_idx_bits = max((N - 1).bit_length(), 1)
    q_max = float((1 << (31 - node_idx_bits)) - 2)
    S = (rng.integers(-4 * 256, 12 * 256, (N, J)) / 256.0).astype(np.float32)
    d = rng.integers(1, 8, J).astype(np.float32)
    md = rng.integers(1, 32, J).astype(np.float32)
    rank = np.sort(rng.integers(0, 4, J)).astype(np.float32)
    may = rng.random(J) < may_frac
    rank = np.where(may, rank, np.float32(tk.RANK_INF)).astype(np.float32)
    key = (
        (rank.clip(0, 3).astype(np.int32) << 24)
        | ((15 - d.astype(np.int32)) << 20)
        | np.arange(J, dtype=np.int32)
    ).astype(np.int32)
    cur = np.where(rng.random(J) < 0.3, rng.integers(0, N, J), -1).astype(np.int32)
    gf = rng.integers(4, 24, N).astype(np.float32)
    gf[rng.random(N) < 0.05] = -1.0  # invalid nodes fold to -1
    mf = rng.integers(32, 160, N).astype(np.float32)
    asg0 = np.full(J, -1, np.int32)
    if seeded:
        seat = (cur >= 0) & may & (rng.random(J) < 0.5)
        asg0[seat] = cur[seat]
    vg = np.where(rng.random(N) < 0.5, 2.0**-6, 2.0**-5).astype(np.float32)
    vm = np.full(N, 2.0**-10, np.float32)
    arrays = (S, d, md, key, rank, cur, asg0, may, gf, mf, vg, vm)
    consts = dict(
        q_lo=-4.0, q_scale=2.0**16, q_max=q_max, node_idx_bits=node_idx_bits
    )
    return arrays, consts


def run_all(arrays, consts, max_rounds):
    ref = pk.mega_rounds_jnp(
        *map(jnp.asarray, arrays), max_rounds=max_rounds, **consts
    )
    pal = pk.mega_solve_pallas(
        *map(jnp.asarray, arrays), max_rounds=max_rounds, interpret=True,
        **consts,
    )
    got = tk.mega_rounds(
        *(torch.from_numpy(np.array(a)) for a in arrays),
        max_rounds=max_rounds, **consts,
    )
    return ref, pal, got


def assert_bitwise(ref, got):
    for i, name in enumerate(("assigned", "gpu_free", "mem_free")):
        want = np.asarray(ref[i])
        have = got[i].numpy()
        assert have.dtype == want.dtype, name
        assert have.tobytes() == want.tobytes(), name
    assert int(got[3]) == int(ref[3]), "rounds"
    assert bool(got[4]) == bool(ref[4]), "capped"


CASES = [
    # (seed, seeded, may_frac, max_rounds)
    (0, False, 1.0, 64),
    (1, True, 1.0, 64),
    (2, True, 0.7, 64),  # may_bid set, as in the fill
    (3, False, 1.0, 3),  # a budget that caps: capped must agree
]


@pytest.mark.parametrize("seed,seeded,may_frac,max_rounds", CASES)
def test_single_window_bitwise(seed, seeded, may_frac, max_rounds):
    arrays, consts = dyadic_inputs(seed, seeded=seeded, may_frac=may_frac)
    assert tk.mega_window(128, 384) == 384  # one window
    ref, pal, got = run_all(arrays, consts, max_rounds)
    assert_bitwise(ref, got)
    assert_bitwise(pal, got)
    assert int(got[3]) > 0


@pytest.mark.parametrize("seed,seeded,may_frac,max_rounds", CASES)
def test_multi_window_bitwise(monkeypatch, seed, seeded, may_frac, max_rounds):
    """W < J in both packages, so the capacities carry across windows."""
    monkeypatch.setattr(pk, "_MEGA_S_BYTES", 128 * 128 * 4)
    monkeypatch.setattr(tk, "_MEGA_S_BYTES", 128 * 128 * 4)
    assert tk.mega_window(128, 384) == pk.mega_window(128, 384) == 128
    arrays, consts = dyadic_inputs(seed, seeded=seeded, may_frac=may_frac)
    ref, pal, got = run_all(arrays, consts, max_rounds)
    assert_bitwise(ref, got)
    assert_bitwise(pal, got)


def test_capped_case_really_caps():
    arrays, consts = dyadic_inputs(3)
    got = tk.mega_rounds(
        *(torch.from_numpy(np.array(a)) for a in arrays),
        max_rounds=1, **consts,
    )
    assert bool(got[4]) and int(got[3]) == 1


@pytest.mark.parametrize(
    "N,J",
    [(8, 64), (64, 64), (128, 384), (1024, 12288), (1024, 65536),
     (2048, 4096), (100, 128), (65536, 64), (16384, 256)],
)
def test_mega_window_matches(N, J):
    assert tk.mega_window(N, J) == pk.mega_window(N, J)


def test_wrapper_on_cpu_is_the_plain_version():
    """A CPU tensor takes the plain version and counts no launch."""
    arrays, consts = dyadic_inputs(4, seeded=True)
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    before = tk.mega_solve.launches
    a = tk.mega_solve(*tensors, max_rounds=64, **consts)
    b = tk.mega_rounds(*tensors, max_rounds=64, **consts)
    assert tk.mega_solve.launches == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrapper_refuses_other_devices():
    arrays, consts = dyadic_inputs(4)
    tensors = [torch.from_numpy(np.array(a)).to("meta") for a in arrays]
    with pytest.raises(ValueError, match="unsupported device"):
        tk.mega_solve(*tensors, max_rounds=64, **consts)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,seeded,may_frac,max_rounds", CASES)
def test_kernel_matches_plain_on_card(seed, seeded, may_frac, max_rounds):
    """The CUDA kernel against its plain version on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    arrays, consts = dyadic_inputs(seed, seeded=seeded, may_frac=may_frac)
    tensors = [torch.from_numpy(np.array(a)).cuda() for a in arrays]
    before = tk.mega_solve.launches
    k = tk.mega_solve(*tensors, max_rounds=max_rounds, **consts)
    p = tk.mega_rounds(*tensors, max_rounds=max_rounds, **consts)
    torch.cuda.synchronize()
    assert tk.mega_solve.launches == before + 1
    for x, y in zip(k, p):
        assert torch.equal(x, y)


def _mega_buckets():
    return [(N, J) for N in BUCKETS for J in BUCKETS
            if resolve_accel("auto", J, N) == "mega"]


@pytest.mark.parametrize("sms", [132, 128])
def test_mega_plan_covers_every_routed_bucket(sms):
    """Every (N, J) bucket pair the router sends to mega, and the tests'
    explicit shapes, get a plan that splits the nodes evenly and fits the
    card's shared memory."""
    shapes = [(N, tk.mega_window(N, J)) for N, J in _mega_buckets()]
    shapes += [(128, 384), (128, 128)]  # accel="mega" in the tests
    assert len(shapes) > 100
    for N, W in shapes:
        plan = tk.mega_plan(N, W, sms)
        assert plan.rows * plan.blocks == N, (N, W)
        assert plan.blocks <= sms and plan.rows <= tk.MEGA_THREADS
        assert plan.smem == tk.mega_smem_bytes(plan.rows, W, plan.vec_smem)
        assert plan.smem <= 232448, (N, W, plan)


@pytest.mark.parametrize("N,W,vec", [(1024, 2048, True), (16384, 128, True),
                                     (128, 16384, False)])
def test_mega_plan_headline_shapes(N, W, vec):
    plan = tk.mega_plan(N, W, 132)
    assert (plan.blocks, plan.rows, plan.vec_smem) == (128, N // 128, vec)


def test_mega_plan_refuses_what_it_cannot_hold():
    with pytest.raises(ValueError, match="no launch plan"):
        tk.mega_plan(8, 262144, 132)  # a 1 MiB row a block


def _walk(arrays, consts, max_rounds):
    tensors = [torch.from_numpy(np.array(a)) for a in arrays]
    got = tk.mega_rounds(*tensors, max_rounds=max_rounds, **consts)
    walk = tk.mega_walk(*tensors, max_rounds=max_rounds, **consts)
    return got, walk


@pytest.mark.parametrize("multi", [False, True], ids=["one", "multi"])
@pytest.mark.parametrize("seed,seeded,may_frac,max_rounds", CASES)
def test_mega_walk_counts(monkeypatch, multi, seed, seeded, may_frac,
                          max_rounds):
    """mega_walk's rounds are mega_rounds' rounds; two barriers a round
    and one a launch; no more windows entered than there are."""
    if multi:
        monkeypatch.setattr(tk, "_MEGA_S_BYTES", 128 * 128 * 4)
    arrays, consts = dyadic_inputs(seed, seeded=seeded, may_frac=may_frac)
    got, walk = _walk(arrays, consts, max_rounds)
    windows, rounds, fenced, barriers = walk.tolist()
    assert walk.dtype == torch.int64
    assert rounds == int(got[3])
    assert barriers == 1 + 2 * rounds
    assert 0 < windows <= 384 // tk.mega_window(128, 384)
    assert 0 <= fenced <= rounds


def test_mega_walk_fences_mixed_ranks_only():
    """A window whose unplaced jobs share one rank needs no fence; a
    window that mixes ranks fences at least once."""
    arrays, consts = dyadic_inputs(0)
    rank = arrays[4]
    assert rank.min() < rank.max()
    _, walk = _walk(arrays, consts, 64)
    assert int(walk[2]) >= 1
    one_rank = list(arrays)
    one_rank[4] = np.zeros_like(rank)
    _, walk = _walk(one_rank, consts, 64)
    assert int(walk[1]) > 0 and int(walk[2]) == 0


# (N, J, window bytes or None, seed, seeded, may_frac, max_rounds; "fill"
# is the gang fill's per-window cap, W + 1)
CARD_CASES = [
    (128, 384, None, 0, False, 1.0, 64),  # one window, R = 1
    (128, 384, 128 * 128 * 4, 1, True, 1.0, 64),  # three windows
    (1024, 384, None, 2, True, 0.7, 64),  # R = 8, may_bid set
    (1024, 4096, None, 3, False, 1.0, 64),  # two windows of 2048
    (16384, 384, None, 4, False, 1.0, 64),  # R = 128, three windows of 128
    (128, 16384, None, 7, False, 1.0, 64),  # W = 16384: job words from L2
    (1024, 4096, None, 5, False, 1.0, 3),  # capped
    (1024, 4096, None, 6, True, 0.7, "fill"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,J,sbytes,seed,seeded,may_frac,max_rounds",
                         CARD_CASES)
def test_kernel_bitwise_at_width_on_card(monkeypatch, N, J, sbytes, seed,
                                         seeded, may_frac, max_rounds):
    """The kernel against mega_rounds at N 128, 1024 and 16384, one
    window and several, capped, the fill's W + 1 cap: three launches back
    to back on the same inputs, every output bitwise equal, and the
    kernel's own walk count equal to mega_walk's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    if sbytes is not None:
        monkeypatch.setattr(tk, "_MEGA_S_BYTES", sbytes)
    W = tk.mega_window(N, J)
    cap = W + 1 if max_rounds == "fill" else max_rounds
    arrays, consts = dyadic_inputs(seed, N=N, J=J, seeded=seeded,
                                   may_frac=may_frac)
    tensors = [torch.from_numpy(np.array(a)).cuda() for a in arrays]
    counter = torch.zeros(4, dtype=torch.int64, device="cuda")
    monkeypatch.setattr(tk.mega_solve, "walk_counter", counter)
    outs = [tk.mega_solve(*tensors, max_rounds=cap, **consts)
            for _ in range(3)]
    want = tk.mega_rounds(*tensors, max_rounds=cap, **consts)
    walk = tk.mega_walk(*tensors, max_rounds=cap, **consts)
    torch.cuda.synchronize()
    assert int(want[3]) > 0
    if max_rounds == 3:
        assert bool(want[4])
    for got in outs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    assert torch.equal(counter.cpu(), 3 * walk)
