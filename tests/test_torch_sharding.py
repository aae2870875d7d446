"""The port's ``inference/sharding.py`` against the JAX package's, on the
CPU: the reference on its 8 virtual devices (``tests/conftest.py``), the
port on a mesh of repeated ``cpu`` devices, ``tiny`` and small GQA /
qkv-bias shapes with the reference's parameters carried across
(``weights.params_from_reference``).

- The device order (``order_devices_ici``, ``mesh_device_array``) on the
  reference tests' fake chip grids: the same walk.
- The mesh's shapes and the device-count door, and the layout's doors
  (``EngineLayout``, ``check_model``): the reference's messages.
- ``param_specs`` (MoE branch as data) and every rank's shard of
  ``shard_params`` BITWISE the reference's addressable shard on its
  device, with the same spec, plain, with qkv biases, and int8 (codes
  and scales per ``expand_quant_specs``); ``unshard_params`` gives the
  tree back.
- ``forward_tensor_parallel``: logits within 2e-5 of the reference's on
  its mesh (f32: the all-reduce sums partials in another order than
  GSPMD's psum), the greedy tokens equal; the head-divisibility door.
- The routers' ``gspmd=True`` and ``wq_dot(gspmd=True)``: the dense
  routes, equal to the reference's flags on the same inputs (f32 within
  1e-6 of each row's largest value), no kernel called.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference import sharding as js
from kubeinfer_tpu.inference import weight_quant as jwq
from kubeinfer_tpu.inference.config import ModelConfig as JCfg
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import sharding as ts
from kubeinfer_tpu_torch.inference import weight_quant as twq
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.config import ModelConfig as TCfg

from test_torch_kv_quant import q8_inputs

TINY = dict(dataclasses.asdict(JP["tiny"]))
GQA = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
           num_hidden_layers=2, num_attention_heads=8,
           num_key_value_heads=4, max_position_embeddings=512)
MHA8 = dict(GQA, num_key_value_heads=8)
BIAS = dict(TINY, qkv_bias=True, tie_word_embeddings=True)
CPU = ["cpu"] * 8


def cfgs(kw):
    return JCfg(**kw), TCfg(**kw)


def t(a):
    return torch.from_numpy(np.asarray(a))


def carried(kw, seed, int8=False):
    """(reference params, the port's copy) of one config."""
    jcfg, _ = cfgs(kw)
    jp = j_init(jcfg, jax.random.PRNGKey(seed))
    if kw.get("qkv_bias"):
        # nonzero biases, so a misplaced shard shows
        rng = np.random.default_rng(seed)
        for layer in jp["layers"]:
            for name in ("q_bias", "k_bias", "v_bias"):
                layer[name] = jnp.asarray(rng.standard_normal(
                    layer[name].shape).astype(np.float32))
    if int8:
        jp = jwq.quantize_params(jp)
    return jp, tw.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


class _FakeDev:
    def __init__(self, i, coords, core=0):
        self.id, self.coords, self.core_on_chip = i, coords, core


def grid():
    return [_FakeDev(4 * y + x, (x, y, 0)) for y in range(2)
            for x in range(4)]


@pytest.mark.parametrize("devs", [
    grid(), [_FakeDev(0, (0, 0, 0), 1), _FakeDev(1, (1, 0, 0), 0),
             _FakeDev(2, (0, 0, 0), 0), _FakeDev(3, (1, 0, 0), 1)],
    [torch.device("cpu")] * 4,
], ids=["snake", "megacore", "coordless"])
def test_device_order_is_the_references(devs):
    assert ts.order_devices_ici(devs) == js.order_devices_ici(devs)
    if len(devs) == 8:
        for dp, tp, sp in ((1, 4, 2), (2, 4, 1), (1, 2, 4)):
            np.testing.assert_array_equal(
                ts.mesh_device_array(devs, dp, tp, sp),
                js.mesh_device_array(devs, dp, tp, sp))


def test_mesh_shapes_and_doors():
    mesh = ts.make_inference_mesh(tp=2, sp=2, devices=CPU)
    assert mesh.shape == dict(js.make_inference_mesh(tp=2, sp=2).shape)
    assert mesh.size == 8 and mesh.axis_names == ("dp", "tp", "sp")
    for kw in (dict(tp=16), dict(tp=2, sp=1, dp=8)):
        with pytest.raises(ValueError) as want:
            js.make_inference_mesh(**kw)
        with pytest.raises(ValueError) as got:
            ts.make_inference_mesh(**kw, devices=CPU)
        assert str(got.value) == str(want.value)
    assert ts.make_axis_mesh("tp", 2, CPU).shape == {"tp": 2}
    with pytest.raises(ValueError, match="tp=9 needs 9 devices, have 8"):
        ts.make_axis_mesh("tp", 9, CPU)
    if not torch.cuda.is_available():
        # devices=None is every visible card: none here
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            ts.make_inference_mesh(tp=2, sp=1, dp=1)


def test_layout_doors_and_messages():
    lay = ts.EngineLayout()
    assert (lay.tp, lay.mesh, lay.sharded, lay.mesh_devices) == (
        1, None, False, 1)
    sentinel = object()
    assert lay.shard_params(sentinel, None) is sentinel
    assert lay.shard_state(sentinel) is sentinel
    two = ts.EngineLayout.build(2, CPU[:2])
    assert two.sharded and two.mesh_devices == 2 and two.devices == [
        torch.device("cpu")] * 2
    assert ts.EngineLayout.build(1).mesh is None
    for kw_t, kw_j in ((dict(tp=2), dict(tp=2)),
                       (dict(tp=1, mesh=two.mesh),
                        dict(tp=1, mesh=js.EngineLayout.build(2).mesh)),
                       (dict(tp=0), dict(tp=0))):
        with pytest.raises(ValueError) as want:
            js.EngineLayout(**kw_j)
        with pytest.raises(ValueError) as got:
            ts.EngineLayout(**kw_t)
        assert str(got.value) == str(want.value)
    for tp, kw in ((4, TINY), (8, GQA), (3, MHA8)):
        with pytest.raises(ValueError) as want:
            js.EngineLayout.build(tp).check_model(JCfg(**kw))
        with pytest.raises(ValueError) as got:
            ts.EngineLayout.build(tp, CPU[:tp]).check_model(TCfg(**kw))
        assert str(got.value) == str(want.value)
    ts.EngineLayout.build(4, CPU[:4]).check_model(TCfg(**GQA))


def test_param_specs_are_the_references():
    for kw in (TINY, BIAS, dict(TINY, num_local_experts=4)):
        jcfg, tcfg = cfgs(kw)
        want = jax.tree.map(tuple, js.param_specs(jcfg),
                            is_leaf=lambda x: isinstance(
                                x, jax.sharding.PartitionSpec))
        got = ts.param_specs(tcfg)
        assert jax.tree.map(tuple, got, is_leaf=lambda x: isinstance(
            x, ts.P)) == want


def leaves(tree, prefix=""):
    if isinstance(tree, ts.P):
        yield prefix, tree
    elif isinstance(tree, dict) and "qw" not in tree:
        for k, v in tree.items():
            yield from leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}.{i}")
    elif isinstance(tree, dict):
        yield from ((f"{prefix}.{k}", v) for k, v in tree.items())
    else:
        yield prefix, tree


def bits(x):
    """A leaf's bytes as an integer array (bf16 compares bitwise too)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if str(x.dtype) == "bfloat16" else x


@pytest.mark.parametrize("kw,int8", [(TINY, False), (BIAS, False),
                                     (TINY, True)],
                         ids=["plain", "qkv_bias", "int8"])
def test_shard_params_bitwise_the_references(kw, int8):
    jcfg, tcfg = cfgs(kw)
    jp, tp = carried(kw, 3, int8)
    jmesh = js.make_inference_mesh(tp=2, sp=1, dp=1)
    jsh = js.shard_params(jp, jmesh, jcfg)
    sh = ts.shard_params(tp, ts.make_inference_mesh(tp=2, sp=1, dp=1,
                                                    devices=CPU[:2]), tcfg)
    assert sh.tp == 2 and sh.device == torch.device("cpu")
    jleaves = dict(leaves(jsh))
    specs = dict(leaves(sh.specs))
    for r in range(2):
        dev = jmesh.devices[0, r, 0]
        got = dict(leaves(sh.shards[r]))
        assert got.keys() == jleaves.keys() == specs.keys()
        for name, jx in jleaves.items():
            assert tuple(jx.sharding.spec) == tuple(specs[name]), name
            piece = next(s.data for s in jx.addressable_shards
                         if s.device == dev)
            assert got[name].is_contiguous(), name
            assert np.array_equal(bits(got[name]), bits(piece)), (name, r)
    back = ts.unshard_params(sh)
    for (name, x), (_, y) in zip(leaves(back), leaves(tp)):
        assert torch.equal(x, y), name
    # a sharded tree on its own mesh comes back as it is
    assert ts.shard_params(sh, sh.mesh, tcfg) is sh


@pytest.mark.parametrize("kw,tp", [(TINY, 2), (GQA, 4), (BIAS, 2)],
                         ids=["tiny-tp2", "gqa-tp4", "bias-tied-tp2"])
def test_forward_tensor_parallel_matches_reference(kw, tp):
    jcfg, tcfg = cfgs(kw)
    jp, tparams = carried(kw, 4)
    toks = np.random.default_rng(5).integers(0, 256, (2, 16)).astype(
        np.int32)
    want = np.asarray(js.forward_tensor_parallel(
        jp, jnp.asarray(toks), jcfg,
        js.make_inference_mesh(tp=tp, sp=1, dp=1)))
    got = ts.forward_tensor_parallel(
        tparams, t(toks).long(), tcfg,
        ts.make_inference_mesh(tp=tp, sp=1, dp=1, devices=CPU)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_forward_refuses_split_heads():
    jp, tparams = carried(TINY, 4)
    with pytest.raises(ValueError, match="num_key_value_heads=2"):
        ts.forward_tensor_parallel(
            tparams, torch.zeros((1, 4), dtype=torch.long), TCfg(**TINY),
            ts.make_inference_mesh(tp=4, sp=1, devices=CPU))
    # the sequence-parallel forward's door is the reference's
    toks = torch.zeros((1, 6), dtype=torch.long)
    with pytest.raises(ValueError) as want:
        js.forward_sequence_parallel(
            jp, jnp.zeros((1, 6), jnp.int32), JCfg(**TINY),
            js.make_inference_mesh(tp=1, sp=4))
    with pytest.raises(ValueError) as got:
        ts.forward_sequence_parallel(
            tparams, toks, TCfg(**TINY),
            ts.make_inference_mesh(tp=1, sp=4, devices=CPU))
    assert str(got.value) == str(want.value)


def close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    B = got.shape[0]
    err = np.abs(got - want).reshape(B, -1).max(1)
    mag = np.maximum(np.abs(want).reshape(B, -1).max(1), 1.0)
    assert np.isfinite(got).all() and (err <= 1e-6 * mag).all(), err


def test_gspmd_routers_are_the_references(monkeypatch):
    """Shapes every kernel's guard admits (bs 128, D 64), ``gspmd=True``
    on both packages: the dense routes, equal; the port calls no
    kernel."""
    for name in ("decode_attention", "decode_attention_blocks",
                 "decode_attention_blocks_q8"):
        monkeypatch.setattr(tfa, name, None)  # a call would raise
    rng = np.random.default_rng(9)
    B, T, n_kv, G, D, bs, M = 2, 1, 2, 2, 64, 128, 2
    lens = np.asarray([130, 7], np.int32)
    S = bs * M
    q = rng.standard_normal((B, T, n_kv * G, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, n_kv, D)).astype(np.float32)
            for _ in range(2))
    mask = np.arange(S)[None, None, :] < lens[:, None, None]
    close(tfa.decode_attention_auto(t(q), t(k), t(v), t(lens), t(mask),
                                    gspmd=True),
          jfa.decode_attention_auto(q, k, v, lens, mask, gspmd=True))
    pool = rng.standard_normal((1 + B * M, bs, n_kv, D)).astype(np.float32)
    tbl = np.arange(1, 1 + B * M, dtype=np.int32).reshape(B, M)
    close(tfa.decode_attention_blocks_auto(t(q), t(pool), t(pool), t(tbl),
                                           t(lens), t(mask), gspmd=True),
          jfa.decode_attention_blocks_auto(q, pool, pool, tbl, lens, mask,
                                           gspmd=True))
    Tq = 3
    args = q8_inputs(B, Tq, n_kv, G, D, bs, M, [130, 9], 7)
    qm = (np.arange(S)[None, None, :]
          <= (args[-1][:, None] - Tq + np.arange(Tq)[None, :])[:, :, None])
    close(tfa.decode_attention_blocks_q8_auto(*map(t, args), t(qm),
                                              gspmd=True),
          jfa.decode_attention_blocks_q8_auto(*args, qm, gspmd=True))


def test_wq_dot_gspmd_is_the_references(monkeypatch):
    monkeypatch.setattr(twq, "quant_matmul", None)  # a call would raise
    rng = np.random.default_rng(10)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    jleaf = jwq.quantize_weight(jnp.asarray(w))
    tleaf = twq.quantize_weight(t(w))
    assert np.array_equal(tleaf["qw"].numpy(), np.asarray(jleaf["qw"]))
    close(twq.wq_dot(t(x), tleaf, gspmd=True),
          jwq.wq_dot(jnp.asarray(x), jleaf, gspmd=True))
    assert torch.equal(twq.wq_dot(t(x), t(w), gspmd=True), t(x) @ t(w))


class _OnCard1(torch.Tensor):
    """A CPU tensor that reports cuda:1: a tp rank's operand on the
    second card, for the launch helpers' device guard."""

    @property
    def device(self):
        return torch.device("cuda", 1)


@pytest.mark.parametrize("helper", ["_launch", "_split_launch", "_call"])
def test_launchers_run_under_their_tensors_card(monkeypatch, helper):
    """One thread drives every tp rank, so a launcher (which acts on the
    current CUDA device) must be called with the operands' card current:
    each helper switches to cuda:1 for the call and back after, and
    leaves the current device alone when it already is the operands'."""
    current = [0]
    seen = []

    class Guard:
        def __init__(self, dev):
            self.idx = torch.device(dev).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.idx

        def __exit__(self, *exc):
            current[0] = self.prev

    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: current[0],
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda idx: 0, raising=False)
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        empty(*a, **k))
    monkeypatch.setattr(tfa, "_split_tickets",
                        lambda dev, stream, n: torch.zeros(n, dtype=torch.int32))

    class Lib:
        def __getattr__(self, fn):
            return lambda *args: seen.append(current[0]) or 0

    q = torch.zeros((1, 1, 2, 64)).as_subclass(_OnCard1)

    def call():
        if helper == "_launch":
            tfa._launch(Lib(), "f", q, q, 1, 0.5, None)
        elif helper == "_split_launch":
            wrapper = type("W", (), {"walk_counter": None, "launches": 0})
            tfa._split_launch(wrapper, Lib(), "f", q, [q], 1, 128, 64, [1])
        else:
            twq._call(Lib(), "f", q.device, q.data_ptr(), 0)

    call()
    assert seen == [1] and current[0] == 0
    current[0] = 1  # already current: no switch
    monkeypatch.setattr(torch.cuda, "device", None)
    call()
    assert seen == [1, 1] and current[0] == 1
