"""The port's batched route solve against the JAX package's.

On the same seeded numpy inputs:

- the host-side planes: ``batched_prefix_fingerprints`` against chains of
  the reference's ``kv_blocks.prefix_fingerprints``, ``build_match_plane``
  and ``pack_route_arrays`` against the reference's arrays, exactly;
- the pick: ``kernels.route_pick_plain`` against ``route_pick_jnp`` and
  the Pallas ``route_pick_pallas`` in interpret mode, bitwise, with ties
  and dead rows;
- the solve: ``solve_routes(device="cpu")`` in each mode against the
  reference's ``accel="jnp"`` (replica, score, rounds), and
  ``solved_affinity`` against the reference's.

Tolerance: none. Pressures are queue depths (integers) over slots in
{1, 2, 4}, so the bias and the greedy load are exact in f32 whether or
not XLA contracts a multiply-add.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import kv_blocks
from kubeinfer_tpu.router import scoring
from kubeinfer_tpu.solver import pallas_kernels as pk
from kubeinfer_tpu.solver import routing as jr
from kubeinfer_tpu_torch.solver import kernels as tk
from kubeinfer_tpu_torch.solver import routing as tr

CPU = torch.device("cpu")


def test_constants_pinned():
    for name in ("PRESSURE_CLIP", "MATCH_CLIP", "_AUCTION_EPS"):
        assert getattr(tr, name) == getattr(jr, name), name
    for name in ("_FP_SEED", "_FP_PRIME", "_FP_MASK"):
        assert getattr(tr, name) == getattr(kv_blocks, name), name
    assert tk.ROUTE_NEG == pk.ROUTE_NEG
    sig = inspect.signature(tr.solve_routes).parameters
    ref = inspect.signature(jr.solve_routes).parameters
    for name in ("alpha", "stale_penalty", "gamma", "mode", "max_rounds"):
        assert sig[name].default == ref[name].default, name
    assert sig["alpha"].default == scoring.ALPHA_QUEUE_BLOCKS
    assert sig["stale_penalty"].default == scoring.STALE_PENALTY_BLOCKS


# --- host-side planes --------------------------------------------------------


@pytest.mark.parametrize("ragged", [True, False])
def test_batched_fingerprints_equal_reference_chains(ragged):
    rng = np.random.default_rng(7 if ragged else 8)
    if ragged:
        batch = [rng.integers(0, 60_000, int(n)).tolist()
                 for n in rng.integers(0, 90, 24)] + [[], [1, 2, 3]]
    else:
        batch = [rng.integers(0, 60_000, 64).tolist() for _ in range(9)]
    for bs in (1, 3, 4, 16):
        got = tr.batched_prefix_fingerprints(batch, bs, 4096)
        np.testing.assert_array_equal(
            got, jr.batched_prefix_fingerprints(batch, bs, 4096)
        )
        for b, toks in enumerate(batch):
            assert [int(x) for x in got[b] if x != -1] == \
                kv_blocks.prefix_fingerprints(toks, bs)
    clipped = tr.batched_prefix_fingerprints([list(range(64))], 4, 3)
    assert clipped[0].tolist() == kv_blocks.prefix_fingerprints(list(range(64)), 4)[:3]
    with pytest.raises(ValueError):
        tr.batched_prefix_fingerprints([[1]], 0, 4)


def storm_inputs(seed=23, R=24, families=6, block=8, B=40):
    """A small fleet storm (bench.py:fleet_storm_bench's generator, cut
    to size): replicas advertise three families at seeded depths."""
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, 50_000, 8 * block).tolist() for _ in range(families)]
    fp_sets, bss = [], []
    for i in range(R):
        fps = set()
        for k in range(3):
            depth = int(rng.integers(2, 9))
            fps.update(kv_blocks.prefix_fingerprints(
                prefixes[(i + k * 5) % families][: depth * block], block))
        fp_sets.append(frozenset(fps))
        bss.append(block if i % 7 else 0)  # a replica with no summary
    batch = [prefixes[int(rng.integers(0, families))]
             + rng.integers(0, 50_000, int(rng.integers(0, 12))).tolist()
             for _ in range(B)]
    return batch, fp_sets, bss, rng


def test_match_plane_and_pack_equal_reference():
    batch, fp_sets, bss, rng = storm_inputs()
    plane = tr.build_match_plane(batch, fp_sets, bss)
    np.testing.assert_array_equal(plane, jr.build_match_plane(batch, fp_sets, bss))
    assert plane.max() > 0
    R = len(fp_sets)
    args = (
        np.where(rng.random(plane.shape) < 0.1, -1, plane).astype(np.int32),
        rng.integers(0, 200, R).astype(np.float32) / 2.0,  # past the clip too
        rng.random(R) < 0.2,
        rng.choice([0.0, 1.0, 2.0, 4.0], R).astype(np.float32),
        rng.uniform(-0.5, 1.5, R).astype(np.float32),
    )
    got, B, Rp = tr.pack_route_arrays(*args, device="cpu")
    ref, B2, R2 = jr.pack_route_arrays(*args)
    assert (B, Rp) == (B2, R2) == (64, 64)
    for name in ("match", "pressure", "stale", "slots", "headroom", "req_valid"):
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(ref, name)), err_msg=name
        )
    assert tr.build_match_plane([], fp_sets, bss).shape == (0, R)


def test_pack_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.pack_route_arrays(np.zeros((2, 2), np.int32), np.zeros(2), np.zeros(2, bool),
                             np.ones(2), np.ones(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.solved_affinity(np.array([1]), np.ones((2, 4), np.uint8), np.zeros(2),
                           np.ones(2), alpha=4.0, cutoff=1.0)


# --- the pick ----------------------------------------------------------------


def pick_inputs(B, R, seed):
    """Coarse match values force score ties; halves keep the ties exact."""
    rng = np.random.default_rng(seed)
    match = rng.integers(-1, 4, (B, R)).astype(np.int32)
    bias = (rng.integers(-8, 8, R) / 2.0).astype(np.float32)
    active = rng.random(B) < 0.9
    match[B // 2] = -1  # an active row with no candidate
    return match, bias, active


@pytest.mark.parametrize("B,R", [(8, 128), (64, 256), (33, 100), (64, 64)])
def test_route_pick_plain_bitwise(B, R):
    match, bias, active = pick_inputs(B, R, B + R)
    v_j, i_j = pk.route_pick_jnp(match, bias, active)
    v_t, i_t = tk.route_pick_plain(*(torch.from_numpy(a) for a in (match, bias, active)))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert i_t.dtype == torch.int32 and (i_t.numpy()[~active] == -1).all()
    assert i_t.numpy()[B // 2] == -1


def test_route_pick_plain_matches_the_pallas_kernel():
    match, bias, active = pick_inputs(64, 128, 5)
    v_p, i_p = pk.route_pick_pallas(match, bias, active, interpret=True)
    v_t, i_t = tk.route_pick_plain(*(torch.from_numpy(a) for a in (match, bias, active)))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_p))


def test_route_pick_wrapper_on_cpu_is_the_plain_version():
    t = [torch.from_numpy(a) for a in pick_inputs(64, 64, 1)]
    before = tk.route_pick.launches
    for a, b in zip(tk.route_pick(*t), tk.route_pick_plain(*t)):
        assert torch.equal(a, b)
    assert tk.route_pick.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        tk.route_pick(*(x.to("meta") for x in t))


# --- the solve ---------------------------------------------------------------


def dyadic_route_problem(B, R, seed, dead_frac=0.1):
    """Integer queue depths over slots in {1, 2, 4}, stale flags and
    headroom in eighths: every bias term is exact in f32."""
    rng = np.random.default_rng(seed)
    match = rng.integers(0, 9, (B, R)).astype(np.int32)
    match[:, rng.random(R) < dead_frac] = -1  # dead / draining columns
    match[rng.random((B, R)) < 0.05] = -1  # per-request excludes
    slots = rng.choice([1.0, 2.0, 4.0], R).astype(np.float32)
    return (
        match,
        (rng.integers(0, 6, R) / slots).astype(np.float32),
        rng.random(R) < 0.2,
        slots,
        (rng.integers(0, 9, R) / 8.0).astype(np.float32),
    )


SOLVE_CASES = {
    "33x100": (33, 100, 3, {}),
    "200x24": (200, 24, 4, {}),  # storm: many requests per replica
    "200x24_gamma": (200, 24, 5, {"gamma": 2.0, "max_rounds": 3}),
    "9x2_one_round": (9, 2, 6, {"max_rounds": 1}),
}


@pytest.mark.parametrize("mode", ["parity", "greedy", "auction"])
@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_routes_matches_reference(case, mode):
    B, R, seed, kw = SOLVE_CASES[case]
    args = dyadic_route_problem(B, R, seed)
    ref = jr.solve_routes(jr.pack_route_arrays(*args)[0], mode=mode, accel="jnp", **kw)
    rp, _, _ = tr.pack_route_arrays(*args, device="cpu")
    before = tk.route_pick.launches
    got = tr.solve_routes(rp, mode=mode, **kw)
    np.testing.assert_array_equal(got.replica.numpy(), np.asarray(ref.replica))
    np.testing.assert_array_equal(got.score.numpy(), np.asarray(ref.score))
    assert int(got.rounds) == int(ref.rounds)
    assert tk.route_pick.launches == before  # CPU tensors: plain version
    np.testing.assert_array_equal(
        tr.decode_routes(got, B), jr.decode_routes(ref, B)
    )
    if mode != "parity":
        assert int(got.rounds) >= 1


def test_solve_routes_launch_counts(monkeypatch):
    """One pick per parity solve, rounds + 1 per greedy solve, 2 rounds + 1
    per auction solve (counted through the module's pick)."""
    calls = []
    orig = tk.route_pick
    monkeypatch.setattr(tk, "route_pick", lambda *a: calls.append(1) or orig(*a))
    rp, _, _ = tr.pack_route_arrays(*dyadic_route_problem(200, 24, 4), device="cpu")
    for mode, per_round in (("parity", 0), ("greedy", 1), ("auction", 2)):
        calls.clear()
        out = tr.solve_routes(rp, mode=mode)
        assert len(calls) == per_round * int(out.rounds) + 1, mode
    with pytest.raises(ValueError, match="unknown route mode"):
        tr.solve_routes(rp, mode="chaotic")
    moved = rp.to("cpu")
    assert torch.equal(moved.match, rp.match) and out.to("cpu").rounds == out.rounds


def affinity_cases():
    def one(cached_rows, model, pressure, slots, alpha=scoring.ALPHA_QUEUE_BLOCKS,
            cutoff=scoring.PRESSURE_AFFINITY_CUTOFF):
        cached = np.zeros((len(pressure), 8), np.uint8)
        for r in cached_rows:
            cached[r, 3] = 1
        return (np.array(model, np.int32), cached, np.array(pressure, np.float32),
                np.array(slots, np.float32), alpha, cutoff)

    rng = np.random.default_rng(12)
    seeded = (
        rng.integers(0, 16, 200).astype(np.int32),
        (rng.random((64, 16)) < 0.15).astype(np.uint8),
        (rng.integers(0, 5, 64) / 2.0).astype(np.float32),
        rng.choice([1.0, 2.0, 4.0], 64).astype(np.float32),
        scoring.ALPHA_QUEUE_BLOCKS, scoring.PRESSURE_AFFINITY_CUTOFF,
    )
    return {
        # TestSolvedAffinity's three cases
        "hot_node_loses_bit": one([0, 1], [3, 3], [4.0, 0.0], [2.0, 2.0]),
        "sole_cacher_keeps_pull": one([0], [3], [2.0, 2.0], [2.0, 2.0]),
        "no_cache_anywhere": (np.array([1, 2], np.int32), np.zeros((3, 8), np.uint8),
                              np.zeros(3, np.float32), np.ones(3, np.float32), 4.0, 1.0),
        "seeded_200x64": seeded,
    }


@pytest.mark.parametrize("case", list(affinity_cases()))
def test_solved_affinity_matches_reference(case):
    model, cached, pressure, slots, alpha, cutoff = affinity_cases()[case]
    got = tr.solved_affinity(model, cached, pressure, slots, alpha=alpha,
                             cutoff=cutoff, device="cpu")
    ref = jr.solved_affinity(model, cached, pressure, slots, alpha=alpha,
                             cutoff=cutoff)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == cached.dtype
    if case == "hot_node_loses_bit":
        assert got[1, 3] == 1 and got[0, 3] == 0
    if case == "sole_cacher_keeps_pull":
        assert got[0, 3] == 1
    if case == "seeded_200x64":
        assert got.sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("B,R", [(256, 128), (64, 64)])
def test_route_pick_kernel_matches_plain_on_card(B, R):
    """The kernel against its plain version on the same card tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    t = [torch.from_numpy(a).cuda() for a in pick_inputs(B, R, 2)]
    before = tk.route_pick.launches
    got = tk.route_pick(*t)
    want = tk.route_pick_plain(*t)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tk.route_pick.launches == before + 1
