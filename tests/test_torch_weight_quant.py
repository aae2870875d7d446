"""The port's int8 weights against the JAX package's: ``quantize_weight``
codes and scales BITWISE equal (f32 and bf16 inputs, ragged N, an
all-zero tile), requantize exact, the double-quantize guard,
``quant_matmul_plain`` against the reference's Pallas kernel (interpret
mode), its jnp twin and its dense route, and the int8 loading paths
giving the reference's codes bitwise; on a card, kernel #15 against its
plain version.

Tolerances of the plain version against the reference: f32 1e-5 of the
row's largest |value| (the sums run in another order); bf16 one bf16 ulp
of the row's largest |value| (2**-7 of it: both round the same f32 sum
once, which can land one ulp apart). On the card, kernel vs plain: f32
1e-5 of the row's largest |value|, bf16 2**-6 of it (2 bf16 ulps).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import config as jc
from kubeinfer_tpu.inference import model as jm
from kubeinfer_tpu.inference import weight_quant as jq
from kubeinfer_tpu.inference import weights as jw
from kubeinfer_tpu_torch.inference import config as tc
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import weight_quant as tq
from kubeinfer_tpu_torch.inference import weights as tw

DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                    torch.bfloat16)}


def to_np(x):
    x = x.detach().cpu()
    return (x.float() if x.dtype == torch.bfloat16 else x).numpy()


def weight(K, N, seed, zero_tile=False):
    w = np.random.default_rng(seed).standard_normal((K, N)).astype(np.float32)
    if zero_tile:
        w[:, 128:256] = 0.0  # a whole tile of zeros: its scale is 1
    return w


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N", [64, 300])
def test_quantize_weight_bitwise(dtype, N):
    jd, td = DT[dtype]
    w = weight(96, N, N, zero_tile=N > 256)
    jw_ = jnp.asarray(w).astype(jd)
    tw_ = torch.from_numpy(w).to(td)
    want = jq.quantize_weight(jw_)
    got = tq.quantize_weight(tw_)
    assert got["qw"].dtype == torch.int8 and got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["qw"].numpy(), np.asarray(want["qw"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))
    if N > 256:
        assert (got["scale"][128:256] == 1.0).all()
        assert (got["qw"][:, 128:256] == 0).all()
    deq = tq.dequantize_weight(got, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jq.dequantize_weight(want, jnp.float32)))


def test_requantize_is_exact():
    w = torch.from_numpy(weight(48, 96, 9))
    d1 = tq.quantize_weight(w, tile=32)
    d2 = tq.quantize_weight(tq.dequantize_weight(d1), tile=32)
    assert torch.equal(d1["qw"], d2["qw"])
    assert torch.equal(d1["scale"], d2["scale"])


def test_guard_weight_dtype_and_dequantize():
    cfg = tc.PRESETS["tiny"]
    plain = tm.init_params(cfg, seed=0, device="cpu")
    assert tq.params_weight_dtype(plain) == "bf16"
    q = tm.init_params(cfg, seed=0, device="cpu", weight_dtype="int8")
    assert tq.params_weight_dtype(q) == "int8"
    with pytest.raises(ValueError, match="already weight-quantized"):
        tq.quantize_params(q)
    # init_params(int8) is quantize_params of the same draw
    again = tq.quantize_params(plain)
    for a, b in zip(q["layers"], again["layers"]):
        for name in tq.QUANT_LEAVES:
            assert torch.equal(a[name]["qw"], b[name]["qw"])
            assert torch.equal(a[name]["scale"], b[name]["scale"])
    deq = tq.dequantize_params(q)
    assert tq.params_weight_dtype(deq) == "bf16"
    leaf = q["layers"][0]["gate_proj"]
    assert torch.equal(deq["layers"][0]["gate_proj"],
                       leaf["qw"].float() * leaf["scale"][None, :])
    assert deq["embed_tokens"] is q["embed_tokens"]
    with pytest.raises(ValueError, match="weight_dtype"):
        tm.init_params(cfg, device="cpu", weight_dtype="fp8")


def check_rows(got, want, dtype):
    """The module docstring's tolerance, row by row."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.abs(w).max(axis=-1, keepdims=True)
    rel = 1e-5 if dtype == "f32" else 2.0 ** -7
    assert (np.abs(g - w) <= rel * mag + 1e-30).all(), np.abs(g - w).max()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(5, 200, 300), (1, 64, 128)])
def test_plain_matches_reference(dtype, M, K, N):
    jd, td = DT[dtype]
    rng = np.random.default_rng(M + K + N)
    x = rng.standard_normal((M, K)).astype(np.float32)
    d = jq.quantize_weight(jnp.asarray(weight(K, N, K)))
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(td)
    qw = torch.from_numpy(np.asarray(d["qw"]).copy())
    sc = torch.from_numpy(np.asarray(d["scale"]).copy())
    got = tq.quant_matmul_plain(tx, qw, sc)
    assert got.dtype == td and got.shape == (M, N)
    for want in (jq.quant_matmul(jx, d["qw"], d["scale"], interpret=True),
                 jq.quant_matmul_jnp(jx, d["qw"], d["scale"]),
                 jq.quant_matmul_dense(jx, d["qw"], d["scale"])):
        check_rows(to_np(got), want, dtype)
    # the wrapper takes the plain version on the CPU, and folds leading
    # dims into M
    before = tq.quant_matmul.launches
    routed = tq.wq_dot(tx.reshape(1, M, K), {"qw": qw, "scale": sc})
    assert torch.equal(routed.reshape(M, N), got)
    assert tq.quant_matmul.launches == before


def test_no_fallback_off_the_cpu():
    x = torch.empty((2, 64), device="meta")
    qw = torch.empty((64, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        tq.quant_matmul(x, qw, torch.empty((64,), device="meta"))


def state_dict(cfg, seed):
    rng = np.random.default_rng(seed)
    H, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q_dim = cfg.num_attention_heads * cfg.head_dim
    kv_dim = cfg.num_key_value_heads * cfg.head_dim

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(V, H), "model.norm.weight": w(H),
          "lm_head.weight": w(V, H)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}"
        sd.update({
            f"{p}.input_layernorm.weight": w(H),
            f"{p}.post_attention_layernorm.weight": w(H),
            f"{p}.self_attn.q_proj.weight": w(q_dim, H),
            f"{p}.self_attn.k_proj.weight": w(kv_dim, H),
            f"{p}.self_attn.v_proj.weight": w(kv_dim, H),
            f"{p}.self_attn.o_proj.weight": w(H, q_dim),
            f"{p}.mlp.gate_proj.weight": w(F, H),
            f"{p}.mlp.up_proj.weight": w(F, H),
            f"{p}.mlp.down_proj.weight": w(H, F),
        })
    return sd


def assert_trees_equal(got, ref):
    flat_r, tree_r = jax.tree.flatten(ref)
    flat_g, tree_g = jax.tree.flatten(got, is_leaf=torch.is_tensor)
    assert tree_r == tree_g
    for a, b in zip(flat_g, flat_r):
        assert a.dtype == {np.dtype(np.int8): torch.int8,
                           np.dtype(np.float32): torch.float32}[b.dtype]
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("source", ["state_dict", "reference"])
def test_int8_loading_gives_reference_codes(source):
    jcfg, tcfg = jc.PRESETS["tiny"], tc.PRESETS["tiny"]
    if source == "state_dict":
        sd = state_dict(jcfg, 7)
        ref = jw.params_from_state_dict(sd, jcfg, jnp.float32,
                                        weight_dtype="int8")
        got = tw.params_from_state_dict(sd, tcfg, torch.float32,
                                        weight_dtype="int8", device="cpu")
    else:
        ref = jm.init_params(jcfg, jax.random.PRNGKey(3),
                             weight_dtype="int8")
        got = tw.params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    assert_trees_equal(got, jax.tree.map(np.asarray, ref))
    assert tq.params_weight_dtype(got) == "int8"


# --- on the card ---------------------------------------------------------------


# the llama-3-8b projections (K, N): q and o, k and v, gate and up, down
LLAMA_KN = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 1024), (8, 1024, 4096),
                                   (5, 200, 300), (300, 512, 704),
                                   (512, 256, 128), (600, 264, 392),
                                   (77, 4096, 4096), (40, 1040, 272),
                                   (130, 1040, 272)]
                         + [(M, K, N) for M in (8, 40, 512)
                            for K, N in LLAMA_KN])
def test_kernel_matches_plain_on_card(dtype, M, K, N):
    """Each call within tolerance of the plain version; bf16 calls that
    ``qmm_route`` admits (the llama shapes at decode, verify and admit
    sizes, a ragged M of 77, the down projection, whose K splits at
    decode, K and N short of whole 64-deep and 128-wide tiles) launch the
    tensor-core kernel and give the same bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel; no interpret mode)")
    dev = torch.device("cuda")
    td = DT[dtype][1]
    rng = np.random.default_rng(M * N + K)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32))
    d = tq.quantize_weight(torch.from_numpy(weight(K, N, N)).to(dev))
    x = x.to(dev).to(td)
    tc = tq.qmm_route(x, d["qw"])
    assert tc == (dtype == "bf16" and K % 16 == 0 and N % 16 == 0)
    before, before_tc = tq.quant_matmul.launches, tq.quant_matmul.tc_launches
    got = tq.quant_matmul(x, d["qw"], d["scale"])
    want = tq.quant_matmul_plain(x, d["qw"], d["scale"])
    torch.cuda.synchronize()
    assert tq.quant_matmul.launches == before + 1
    assert tq.quant_matmul.tc_launches == before_tc + tc
    assert got.dtype == td and torch.isfinite(got.float()).all()
    if tc:  # the split-K combine adds in a fixed order: the same bits
        assert torch.equal(tq.quant_matmul(x, d["qw"], d["scale"]), got)
    g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
    mag = np.abs(w).max(axis=-1, keepdims=True)
    rel = 1e-5 if dtype == "f32" else 2.0 ** -6
    assert (np.abs(g - w) <= rel * mag).all(), np.abs(g - w).max()
    # quantizing on the card gives the CPU's codes and scales bitwise
    host = tq.quantize_weight(torch.from_numpy(weight(K, N, N)))
    assert torch.equal(d["qw"].cpu(), host["qw"])
    assert torch.equal(d["scale"].cpu(), host["scale"])
