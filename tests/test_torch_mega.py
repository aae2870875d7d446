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
