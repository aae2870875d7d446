"""Kernel #15's route and the tensor-core kernel's split-K plan, on the
CPU: ``qmm_route`` sends every llama-3-8b projection at decode, verify,
admit and chunk sizes to ``csrc/quant_matmul_tc.cu`` and ragged shapes,
f32 and an x view at an odd offset to ``csrc/quant_matmul.cu``;
``qmm_tc_plan`` gives non-empty K ranges that fill the card's blocks;
``quant_matmul_split_plain`` (partial sums over those ranges, added in
split order, scaled once) agrees with the JAX package's Pallas kernel
(interpret mode), its jnp twin and its dense route.

Tolerance of the mirror against the reference, as in
``test_torch_weight_quant.py``: f32 1e-5 of the row's largest |value|,
bf16 one bf16 ulp of it (2**-7: both round an f32 sum, taken in another
order, once).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import weight_quant as jq
from kubeinfer_tpu_torch.inference import weight_quant as tq

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}
# the llama-3-8b projections (K, N)
LLAMA = {"q_proj": (4096, 4096), "k_proj": (4096, 1024),
         "v_proj": (4096, 1024), "o_proj": (4096, 4096),
         "gate_proj": (4096, 14336), "up_proj": (4096, 14336),
         "down_proj": (14336, 4096)}
# decode, a T = 5 verify window over 8 rows, an admit, an engine chunk
SERVING_M = (8, 40, 512, 2048)


def operands(M, K, N, dtype=torch.bfloat16):
    """x and qw as the wrapper sees them (meta tensors: shapes, dtypes
    and an aligned address, no storage)."""
    return (torch.empty((M, K), dtype=dtype, device="meta"),
            torch.empty((K, N), dtype=torch.int8, device="meta"))


@pytest.mark.parametrize("leaf", sorted(LLAMA))
def test_llama_projections_take_the_tensor_core_route(leaf):
    K, N = LLAMA[leaf]
    for M in SERVING_M:
        assert tq.qmm_route(*operands(M, K, N)), (leaf, M)
        # leading dims fold into M: the route reads K and N only
        x, qw = operands(M, K, N)
        assert tq.qmm_route(x.reshape(1, M, K), qw)


@pytest.mark.parametrize("case", ["ragged", "ragged_k", "f32", "odd_offset",
                                  "odd_weight"])
def test_other_calls_take_the_first_kernel(case):
    if case == "ragged":  # the tests' ragged shape: N % 16 != 0
        x, qw = operands(5, 200, 300)
    elif case == "ragged_k":  # K % 16 != 0
        x, qw = operands(600, 264, 392)
    elif case == "f32":
        x, qw = operands(512, 4096, 14336, torch.float32)
    elif case == "odd_offset":  # a bf16 view 2 bytes past an aligned start
        base = torch.zeros(8 * 4096 + 1, dtype=torch.bfloat16)
        x = base[1:].view(8, 4096)
        qw = torch.zeros((4096, 1024), dtype=torch.int8)
        assert x.data_ptr() % 16 == 2
    else:
        x = torch.zeros((8, 4096), dtype=torch.bfloat16)
        qw = torch.zeros(4096 * 1024 + 4, dtype=torch.int8)[4:].view(4096,
                                                                    1024)
    assert not tq.qmm_route(x, qw)


def test_tc_plan_at_the_serving_shapes():
    """Decode sizes pad M to 8 or 64 rows and split K where the weight
    columns alone leave most of the card idle; prefill sizes take
    256-row blocks where those fill the card, else 128-row ones, split
    only k and v at an admit's 512 rows."""
    want = {(8, 4096, 1024): (8, 16, 4), (8, 4096, 4096): (8, 4, 16),
            (8, 4096, 14336): (8, 1, 64), (8, 14336, 4096): (8, 4, 56),
            (40, 4096, 1024): (64, 16, 4), (40, 4096, 14336): (64, 1, 64),
            (77, 4096, 4096): (128, 4, 16), (512, 4096, 1024): (128, 4, 16),
            (512, 4096, 4096): (128, 1, 64),
            (512, 4096, 14336): (256, 1, 64),
            (512, 14336, 4096): (128, 1, 224),
            (2048, 4096, 1024): (128, 1, 64),
            (2048, 4096, 14336): (256, 1, 64),
            (2048, 14336, 4096): (256, 1, 224)}
    for (M, K, N), plan in want.items():
        assert tq.qmm_tc_plan(M, N, K) == plan, (M, K, N)


@pytest.mark.parametrize("M", [1, 8, 9, 40, 64, 65, 512, 2048])
def test_tc_plan_ranges_cover_k(M):
    """Every split walks at least one K tile, the splits cover K, and a
    split is added only while the blocks fall short of the card."""
    for K in (16, 64, 200 * 16, 1024, 4096, 14336):
        for N in (16, 128, 1024, 4096, 14336):
            rows, splits, per = tq.qmm_tc_plan(M, N, K)
            assert rows >= M if M <= 64 else rows in (128, 256)
            k_tiles = -(-K // tq.TC_BK)
            tiles = -(-M // rows) * -(-N // tq.TC_BN)
            assert (splits - 1) * per < k_tiles <= splits * per
            assert splits == 1 or (splits * tiles <= tq.TC_BLOCKS
                                   and per >= tq.TC_MIN_K_TILES)


def check_rows(got, want, dtype):
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.abs(w).max(axis=-1, keepdims=True)
    rel = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert (np.abs(g - w) <= rel * mag + 1e-30).all(), np.abs(g - w).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(5, 1024, 128), (3, 512, 256),
                                   (70, 2048, 64)])
def test_split_mirror_matches_reference(dtype, M, K, N):
    jd, td = DT[dtype]
    assert tq.qmm_tc_plan(M, N, K)[1] > 1  # the combine is exercised
    rng = np.random.default_rng(M * K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = rng.standard_normal((K, N)).astype(np.float32)
    d = jq.quantize_weight(jnp.asarray(w))
    qw = torch.from_numpy(np.asarray(d["qw"]).copy())
    sc = torch.from_numpy(np.asarray(d["scale"]).copy())
    got = tq.quant_matmul_split_plain(torch.from_numpy(x).to(td), qw, sc)
    assert got.dtype == td and got.shape == (M, N)
    got = got.float().numpy()
    jx = jnp.asarray(x).astype(jd)
    for want in (jq.quant_matmul(jx, d["qw"], d["scale"], interpret=True),
                 jq.quant_matmul_jnp(jx, d["qw"], d["scale"]),
                 jq.quant_matmul_dense(jx, d["qw"], d["scale"])):
        check_rows(got, want, dtype)
