"""The tensor-core prefill kernel (``csrc/flash_prefill_tc.cu``), the bf16
route of #9 (``flash_attention_ragged``), #13 (``flash_ragged_lse``) and
#9b (``flash_attention``), against the plain versions on a card; the
route choice on the CPU.

Tolerances (on the card): bf16 outputs within 2**-6 (2 bf16 ulps) of
each row's largest |plain value| (bf16 x bf16 products are exact in f32;
the kernel sums them in another order); #13's lse within 1e-4 absolute
(f32 logsumexp, sums in another order); #13's o bitwise #9's (one kernel,
one walk).
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from kubeinfer_tpu_torch.inference import flash_attention as tfa
from test_torch_flash_mask import late_mask, packed_mask

BF16_REL = 2.0 ** -6
LSE_ABS = 1e-4


def test_tc_route_is_static_by_dtype_and_shape():
    """bf16 with D % 64 == 0 (up to 256) and G <= 64 takes the
    tensor-core kernel; f32 and other head widths the CUDA-core one."""
    def q(dtype, H, D):
        return torch.empty((1, 8, H, D), dtype=dtype, device="meta")

    for D in (64, 128, 192, 256):
        assert tfa.tc_route(q(torch.bfloat16, 32, D), 8)
        assert not tfa.tc_route(q(torch.float32, 32, D), 8)
    for D in (16, 32, 48, 80, 272):
        assert not tfa.tc_route(q(torch.bfloat16, 32, D), 8)
    assert tfa.tc_route(q(torch.bfloat16, 64, 128), 1)
    assert not tfa.tc_route(q(torch.bfloat16, 128, 128), 1)


# --- on the card -------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    return torch.device("cuda")


def _inputs(B, T, S, H, n_kv, D, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev).to(torch.bfloat16)
            for s in ((B, T, H, D), (B, S, n_kv, D), (B, S, n_kv, D))]


def _held(got, want):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    g, w = g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])
    err = (g - w).abs().amax(dim=1)
    assert bool((err <= BF16_REL * w.abs().amax(dim=1)).all()), \
        float(err.max())


# (B, T, S, H, n_kv, q_offset, row_lens): T * G off the 64-row block (37 x
# 4 = 148, 45 x 8), G = 3 (21 positions, 63 of a block's 64 rows), S off
# the 64-key tile, q_offset 0 and 160, a row of length 0 (its defined
# output: the uniform mean of v over all S keys)
RAGGED = [
    (2, 37, 200, 8, 2, 0, [37, 0]),
    (3, 37, 200, 8, 2, 160, [200, 0, 150]),
    (1, 45, 300, 16, 2, 160, [205]),
    (2, 96, 256, 4, 4, 160, [256, 100]),
    (1, 50, 230, 6, 2, 160, [210]),
]


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 256])
@pytest.mark.parametrize("case", range(len(RAGGED)))
def test_ragged_and_lse_match_plain(D, case):
    """#9 and #13 on the tensor-core route: within tolerance of their
    plain versions, one tensor-core launch each, #13's o bitwise #9's."""
    dev = _card()
    B, T, S, H, n_kv, off, lens = RAGGED[case]
    q, k, v = _inputs(B, T, S, H, n_kv, D, seed=D + case, dev=dev)
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    n9 = (tfa.flash_attention_ragged.launches,
          tfa.flash_attention_ragged.tc_launches)
    n13 = (tfa.flash_ragged_lse.launches, tfa.flash_ragged_lse.tc_launches)
    o9 = tfa.flash_attention_ragged(q, k, v, off, ln)
    o13, lse = tfa.flash_ragged_lse(q, k, v, off, ln)
    torch.cuda.synchronize()
    assert (tfa.flash_attention_ragged.launches,
            tfa.flash_attention_ragged.tc_launches) == (n9[0] + 1, n9[1] + 1)
    assert (tfa.flash_ragged_lse.launches,
            tfa.flash_ragged_lse.tc_launches) == (n13[0] + 1, n13[1] + 1)
    assert torch.equal(o9, o13)
    want, want_lse = tfa.flash_ragged_lse_plain(q, k, v, off, ln)
    _held(o9, want)
    assert float((lse - want_lse).abs().max()) <= LSE_ABS
    for b in (i for i, n in enumerate(lens) if n == 0):
        mean = v[b].float().mean(dim=0).repeat_interleave(H // n_kv, dim=0)
        _held(o9[b], mean.expand(T, H, D).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_masked_matches_plain(D):
    """#9b on the tensor-core route: a packed-document mask with rows that
    see nothing (the uniform mean of v), a random mask, rows whose first
    live key lies after skipped tiles, and S = 100 (the byte-load mask
    path); one tensor-core launch each, folding the key tiles that
    ``flash_mask_walk`` names, as the kernel's own count says."""
    dev = _card()
    rng = np.random.default_rng(D)
    cases = [
        (256, 256, packed_mask(256, [64, 128, 48], 16)[None]),
        (128, 512, rng.random((2, 128, 512)) < 0.05),
        (128, 384, late_mask(128, 384, 200, 260)[None]),
        (64, 100, rng.random((2, 64, 100)) < 0.3),
    ]
    H, n_kv = 8, 2
    for T, S, mask in cases:
        B = mask.shape[0]
        q, k, v = _inputs(B, T, S, H, n_kv, D, seed=D + S, dev=dev)
        m = torch.from_numpy(np.ascontiguousarray(mask)).to(dev)
        n0 = (tfa.flash_attention.launches, tfa.flash_attention.tc_launches)
        walked = torch.zeros(1, dtype=torch.int32, device=dev)
        tfa.flash_attention.walk_counter = walked
        try:
            got = tfa.flash_attention(q, k, v, m)
        finally:
            tfa.flash_attention.walk_counter = None
        torch.cuda.synchronize()
        assert (tfa.flash_attention.launches,
                tfa.flash_attention.tc_launches) == (n0[0] + 1, n0[1] + 1)
        walk = tfa.flash_mask_walk(m, tfa.TC_ROWS // (H // n_kv),
                                   tfa.TC_KEYS)
        assert int(walked) == n_kv * int(walk.sum())
        _held(got, tfa.flash_attention_plain(q, k, v, m))
        dead = ~m.any(dim=2)
        mean = v.float().mean(dim=1).repeat_interleave(4, dim=1)
        for b, t in dead.nonzero().tolist():
            _held(got[b, t], mean[b].to(torch.bfloat16))


@pytest.mark.cuda
def test_f32_stays_on_cuda_cores():
    """f32 takes the CUDA-core kernel (full f32, 1e-5 of the plain
    version); no tensor-core launch."""
    dev = _card()
    q, k, v = (x.float() for x in _inputs(1, 64, 128, 8, 2, 128, 5, dev))
    ln = torch.tensor([128], dtype=torch.int32, device=dev)
    n0 = tfa.flash_attention_ragged.tc_launches
    got = tfa.flash_attention_ragged(q, k, v, 64, ln)
    torch.cuda.synchronize()
    assert tfa.flash_attention_ragged.tc_launches == n0
    want = tfa.flash_attention_ragged_plain(q, k, v, 64, ln)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_products_run_on_tensor_cores():
    """The built library's SASS holds HGMMA (wgmma) instructions."""
    _card()
    from kubeinfer_tpu_torch import _build

    path, _ = _build.build("flash_prefill_tc")
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", str(path)], check=True,
                          capture_output=True, text=True).stdout
    assert "HGMMA" in sass
