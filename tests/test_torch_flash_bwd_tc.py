"""The tensor-core backward kernels (``csrc/flash_backward_tc.cu``), the
bf16 route of #14 (``flash_bwd_dq``, ``flash_bwd_dkv``) for D 64 and 128:
on the CPU, the route choice and the kernels' walk (``flash_bwd_walk``)
against the ragged-causal rule of the plain backward; on a card, the
kernels against the plain versions.

Tolerances: on the CPU the walked fold is bitwise the fold of every step
(a skipped step adds exactly 0) and within 1e-5 of the plain versions in
f32 (the same products, tiled otherwise); on the card bf16 gradients
within 2**-6 (2 bf16 ulps) of each row's largest |plain value| (bf16 x
bf16 products are exact in f32; the sums run in another order, which can
move a rounded dS by one ulp), f32 within 1e-5, and rows with row_len ==
0 exactly zero. A dQ or dK row whose dS cancels (a query's first key,
where P = 1 and dP - drow is f32 rounding) is held instead to its
rounding floor, ``flash_bwd_noise``, where that is larger: the tensor
cores sum dP in another order than the plain version, so such a row is
noise on both sides.
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import flash_attention as tfa

BF16_REL = 2.0 ** -6

# (B, T, S, H, n_kv, q_offset, row_lens): the cases of
# test_torch_flash_backward.py (ragged rows, GQA, an empty row) at the
# kernels' tiles, the card case (one empty row) at q_offset 0 and 160, T
# and S off the tiles (37 x 4 folded rows, 200 and 300 keys), and G = 3
# (21 positions fill 63 of a tile's 64 rows)
WALK_CASES = {
    "multi_tile": (2, 32, 32, 4, 4, 0, [32, 20]),
    "gqa": (1, 32, 32, 4, 2, 0, [25]),
    "empty_row": (2, 32, 32, 4, 4, 0, [20, 0]),
    "card_offset0": (3, 96, 256, 8, 2, 0, [256, 0, 37]),
    "card_offset160": (3, 96, 256, 8, 2, 160, [256, 0, 197]),
    "unaligned": (2, 37, 200, 8, 2, 0, [37, 0]),
    "unaligned_offset": (1, 45, 300, 16, 2, 160, [205]),
    "g3": (1, 50, 230, 6, 2, 160, [210]),
}


def test_tc_bwd_route_is_static_by_dtype_and_shape():
    """bf16 with D 64 or 128 and G <= 64 takes the tensor-core kernels;
    f32, wider heads (their dK and dV do not fit a warpgroup's registers)
    and other widths the CUDA-core ones."""
    def q(dtype, H, D):
        return torch.empty((1, 8, H, D), dtype=dtype, device="meta")

    for D in (64, 128):
        assert tfa.tc_bwd_route(q(torch.bfloat16, 32, D), 8)
        assert not tfa.tc_bwd_route(q(torch.float32, 32, D), 8)
    for D in (16, 32, 48, 80, 192, 256):
        assert not tfa.tc_bwd_route(q(torch.bfloat16, 32, D), 8)
    assert tfa.tc_bwd_route(q(torch.bfloat16, 64, 128), 1)
    assert not tfa.tc_bwd_route(q(torch.bfloat16, 128, 128), 1)


def _live(T, S, q_offset, lens):
    """bool [B, T, S]: the ragged-causal rule of ``_bwd_tiles``."""
    t = q_offset + torch.arange(T)[:, None]
    s = torch.arange(S)[None, :]
    return torch.stack([(s <= t) & (s < n) for n in lens])


def _steps(live, rows, cols):
    """bool [B, ceil(R / rows), ceil(C / cols)]: which (rows x cols) steps
    of a [B, R, C] pair mask hold a live pair."""
    B, R, C = live.shape
    nr, nc = -(-R // rows), -(-C // cols)
    pad = torch.zeros((B, nr * rows, nc * cols), dtype=torch.bool)
    pad[:, :R, :C] = live
    return pad.reshape(B, nr, rows, nc, cols).any(dim=4).any(dim=2)


@pytest.mark.parametrize("name", list(WALK_CASES))
def test_walk_is_the_live_steps(name):
    """``flash_bwd_walk`` folds every (block, tile) step that holds a live
    pair and no other: each live pair lies in a walked step of both
    kernels, and each walked step holds one."""
    B, T, S, H, n_kv, off, lens = WALK_CASES[name]
    G = H // n_kv
    tb = tfa.TC_ROWS // G
    dq, dkv = tfa.flash_bwd_walk(T, S, off, torch.tensor(lens), G)
    live = _live(T, S, off, lens)
    assert dq.shape == (B, -(-T // tb), -(-S // tfa.TC_KEYS))
    assert dkv.shape == (B, -(-S // tfa.TC_BWD_KEYS), -(-T // tb))
    assert torch.equal(dq, _steps(live, tb, tfa.TC_KEYS))
    assert torch.equal(dkv, _steps(live.transpose(1, 2), tfa.TC_BWD_KEYS,
                                   tb))
    for b, n in enumerate(lens):
        if n == 0:
            assert not dq[b].any() and not dkv[b].any()


def _bwd_blocks(q, k, v, do, lse, drow, q_offset, lens, walk=None):
    """#14 as the tensor-core kernels run it, in f32: dQ by query tile,
    folding in ascending order the key tiles that ``walk``'s dq grid
    marks; dK/dV by key block, folding the query tiles of its dkv grid
    (every step where ``walk`` is None). P = exp(q.k * scale + pen - lse)
    (0 on rows with row_len == 0), dS = P * (dO.v - drow), dS and P
    rounded to the input dtype before their products. Returns f32 (dq
    [B, T, H, D], dk, dv [B, S, n_kv, D])."""
    B, T, H, D = q.shape
    S, n_kv = k.shape[1], k.shape[2]
    G = H // n_kv
    tb = tfa.TC_ROWS // G
    scale = 1.0 / float(D) ** 0.5
    qf, dof = tfa._fold_q(q, n_kv).float(), tfa._fold_q(do, n_kv).float()
    kf, vf = tfa._linear_kv(k, n_kv).float(), tfa._linear_kv(v, n_kv).float()
    q_pos = q_offset + torch.arange(T)
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(kf)

    def pds(b, t0, t1, s0, s1):
        rows = slice(t0 * G, t1 * G)
        ns = slice(b * n_kv, (b + 1) * n_kv)
        lens_b = torch.full((n_kv,), int(lens[b]), dtype=torch.int64)
        s = torch.matmul(qf[ns, rows], kf[ns, s0:s1].transpose(-1, -2)) * scale
        pen = tfa._ragged_pen(q_pos[t0:t1], torch.arange(s0, s1), lens_b)
        s = (s.reshape(n_kv, t1 - t0, G, s1 - s0) + pen[:, :, None]).reshape(
            n_kv, (t1 - t0) * G, s1 - s0)
        p = torch.exp(s - lse[ns, rows]) if lens[b] > 0 else torch.zeros_like(s)
        dp = torch.matmul(dof[ns, rows], vf[ns, s0:s1].transpose(-1, -2))
        return ns, rows, p, p * (dp - drow[ns, rows])

    grids = walk if walk is not None else tfa.flash_bwd_walk(
        T, S, q_offset, lens, G)
    for b in range(B):
        for j in range(grids[0].shape[1]):
            t0, t1 = j * tb, min(T, (j + 1) * tb)
            for i in range(grids[0].shape[2]):
                if walk is not None and not bool(walk[0][b, j, i]):
                    continue
                s0, s1 = i * tfa.TC_KEYS, min(S, (i + 1) * tfa.TC_KEYS)
                ns, rows, _, ds = pds(b, t0, t1, s0, s1)
                dq[ns, rows] += torch.matmul(ds.to(k.dtype).float(),
                                             kf[ns, s0:s1])
        for i in range(grids[1].shape[1]):
            s0 = i * tfa.TC_BWD_KEYS
            s1 = min(S, s0 + tfa.TC_BWD_KEYS)
            for j in range(grids[1].shape[2]):
                if walk is not None and not bool(walk[1][b, i, j]):
                    continue
                t0, t1 = j * tb, min(T, (j + 1) * tb)
                ns, rows, p, ds = pds(b, t0, t1, s0, s1)
                dv[ns, s0:s1] += torch.matmul(
                    p.to(do.dtype).float().transpose(-1, -2), dof[ns, rows])
                dk[ns, s0:s1] += torch.matmul(
                    ds.to(q.dtype).float().transpose(-1, -2), qf[ns, rows])

    def unfold_kv(x):
        return x.reshape(B, n_kv, S, D).transpose(1, 2)

    return (tfa._unfold_q(dq * scale, B, T, H, n_kv), unfold_kv(dk * scale),
            unfold_kv(dv))


def _inputs(B, T, S, H, n_kv, D, q_offset, lens, seed, dtype, dev="cpu"):
    """q, k, v, dO and row_lens from seeded numpy, with #13's lse and
    drow from the forward on the same device."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(dev).to(dtype)
        for s in ((B, T, H, D), (B, S, n_kv, D), (B, S, n_kv, D),
                  (B, T, H, D)))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    o, lse = tfa.flash_ragged_lse(q, k, v, q_offset, ln)
    return q, k, v, do, lse, tfa.flash_bwd_drow(o, do, n_kv), ln


@pytest.mark.parametrize("name", ["unaligned", "unaligned_offset", "g3"])
def test_walked_fold_is_the_full_fold(name):
    """Folding only the steps of ``flash_bwd_walk`` (f32, D = 16, the
    kernels' tiles) is bitwise the fold of every step, skips steps of at
    least one kernel, and is within 1e-5 of the plain versions."""
    B, T, S, H, n_kv, off, lens = WALK_CASES[name]
    q, k, v, do, lse, drow, ln = _inputs(B, T, S, H, n_kv, 16, off, lens,
                                         seed=T + S, dtype=torch.float32)
    walk = tfa.flash_bwd_walk(T, S, off, ln, H // n_kv)
    assert not (bool(walk[0].all()) and bool(walk[1].all()))
    walked = _bwd_blocks(q, k, v, do, lse, drow, off, lens, walk)
    full = _bwd_blocks(q, k, v, do, lse, drow, off, lens)
    want = (tfa.flash_bwd_dq_plain(q, k, v, do, lse, drow, off, ln),
            *tfa.flash_bwd_dkv_plain(q, k, v, do, lse, drow, off, ln))
    for got, all_steps, plain in zip(walked, full, want):
        assert torch.equal(got, all_steps)
        torch.testing.assert_close(got, plain, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["card_offset0", "unaligned"])
def test_noise_floor_governs_only_cancelling_rows(name):
    """``flash_bwd_noise`` (bf16, D = 64): zero on rows with row_len == 0
    and larger than 2**-6 of a dQ row's magnitude only at a row's first
    two positions, where dS = P * (dP - drow) is mostly rounding (one or
    two keys, P near 1); never for dK here."""
    B, T, S, H, n_kv, off, lens = WALK_CASES[name]
    args = _inputs(B, T, S, H, n_kv, 64, off, lens, seed=64,
                   dtype=torch.bfloat16)
    args = (*args[:6], off, args[6])
    dq_n, dk_n = tfa.flash_bwd_noise(*args)
    dq = tfa.flash_bwd_dq_plain(*args)
    dk, _ = tfa.flash_bwd_dkv_plain(*args)
    assert dq_n.shape == dq.shape and dk_n.shape == dk.shape
    assert bool((dq_n >= 0).all()) and bool((dk_n >= 0).all())
    for b, n in enumerate(lens):
        if n == 0:
            assert not dq_n[b].any() and not dk_n[b].any()
    governs = dq_n.amax(-1) > BF16_REL * dq.float().abs().amax(-1)
    assert governs.any() and not governs[:, 2:].any()
    assert not (dk_n.amax(-1) > BF16_REL * dk.float().abs().amax(-1)).any()


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _held(got, want, noise=None):
    """Finite, and each row of the last axis within 1e-5 (f32) or 2**-6
    (bf16) of that row's largest |plain value|, or, for dQ and dK, within
    the row's f32 rounding floor (``flash_bwd_noise``) where that is
    larger: a row whose dS cancels to rounding noise (a query's first
    key) has no magnitude of its own."""
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    err = (g - w).abs().amax(dim=1)
    if got.dtype == torch.float32:
        assert float(err.max()) <= 1e-5
        return
    tol = BF16_REL * w.abs().amax(dim=1)
    if noise is not None:
        tol = torch.maximum(tol, noise.float().cpu().reshape(
            -1, g.shape[-1]).amax(dim=1))
    assert bool((err <= tol).all()), float(err.max())


def _run(D, case, dtype, seed):
    """Both wrappers on the card with their walk counters set: (dq, dk,
    dv, the plain versions', the counters, the launch counts before)."""
    dev = _card()
    B, T, S, H, n_kv, off, lens = WALK_CASES[case]
    q, k, v, do, lse, drow, ln = _inputs(B, T, S, H, n_kv, D, off, lens,
                                         seed=seed, dtype=dtype, dev=dev)
    before = [(w.launches, w.tc_launches)
              for w in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]
    counters = [torch.zeros(1, dtype=torch.int32, device=dev)
                for _ in range(2)]
    tfa.flash_bwd_dq.walk_counter, tfa.flash_bwd_dkv.walk_counter = counters
    try:
        dq = tfa.flash_bwd_dq(q, k, v, do, lse, drow, off, ln)
        dk, dv = tfa.flash_bwd_dkv(q, k, v, do, lse, drow, off, ln)
    finally:
        tfa.flash_bwd_dq.walk_counter = tfa.flash_bwd_dkv.walk_counter = None
    torch.cuda.synchronize()
    plain = (tfa.flash_bwd_dq_plain(q, k, v, do, lse, drow, off, ln),
             *tfa.flash_bwd_dkv_plain(q, k, v, do, lse, drow, off, ln))
    noise = (*tfa.flash_bwd_noise(q, k, v, do, lse, drow, off, ln), None)
    return (dq, dk, dv), plain, noise, [int(c) for c in counters], before


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("case", ["card_offset0", "card_offset160",
                                  "unaligned", "unaligned_offset", "g3"])
def test_kernels_match_plain(D, case):
    """dQ and dK/dV on the tensor-core route: within tolerance of the
    plain versions, exactly zero on empty rows, one tensor-core launch
    each, and each kernel's own count of folded steps n_kv times
    ``flash_bwd_walk``'s."""
    got, plain, noise, walked, before = _run(D, case, torch.bfloat16,
                                             seed=D)
    for g, w, n in zip(got, plain, noise):
        assert g.dtype == torch.bfloat16
        _held(g, w, n)
    B, T, S, H, n_kv, off, lens = WALK_CASES[case]
    for b, n in enumerate(lens):
        if n == 0:
            for g in got:
                assert torch.count_nonzero(g[b]) == 0
    after = [(w.launches, w.tc_launches)
             for w in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv)]
    assert after == [(n + 1, t + 1) for n, t in before]
    dq_walk, dkv_walk = tfa.flash_bwd_walk(T, S, off, torch.tensor(lens),
                                           H // n_kv)
    assert walked == [n_kv * int(dq_walk.sum()), n_kv * int(dkv_walk.sum())]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D", [(torch.float32, 128),
                                     (torch.bfloat16, 192),
                                     (torch.bfloat16, 256)])
def test_other_calls_stay_on_cuda_cores(dtype, D):
    """f32 and bf16 heads wider than 128 take ``flash_backward.cu``: no
    tensor-core launch, no walk counted, within tolerance."""
    got, plain, _, walked, before = _run(D, "unaligned", dtype, seed=7)
    for g, w in zip(got, plain):
        _held(g, w)
    assert [(w.launches, w.tc_launches)
            for w in (tfa.flash_bwd_dq, tfa.flash_bwd_dkv)] == [
        (n + 1, t) for n, t in before]
    assert walked == [0, 0]


@pytest.mark.cuda
def test_products_run_on_tensor_cores():
    """The built library's SASS holds HGMMA (wgmma) instructions."""
    _card()
    from kubeinfer_tpu_torch import _build

    path, _ = _build.build("flash_backward_tc")
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    assert "HGMMA" in sass
