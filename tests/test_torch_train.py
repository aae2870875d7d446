"""The port's training step against the JAX package's ``train.py``, on
the ``tiny`` preset with the same weights (the reference's tree carried
over by ``weights.params_from_reference``) and the same seeded tokens.

Routes: the dense one (``forward``'s default on the CPU on both sides)
and the flash one, forced on both sides as the reference's
``test_train_loss_differentiates_with_flash`` forces it (TILE_T/TILE_S
8/16, the reference's Pallas kernels in interpret mode, the port's plain
versions). The JAX results are computed once per module.

Tolerances (f32): the loss within 1e-6 relative and every gradient leaf
within 1e-5 absolute (the same math; sums and matmuls in another order);
the parameters after one step within 1e-7 absolute (lr 1e-3 times those
gradients). ``_sgd`` alone, on the same gradients: bitwise in f32, within
one bf16 ulp in bf16 (XLA may fuse the multiply and the subtract that
PyTorch rounds separately).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubeinfer_tpu.inference import PRESETS as JPRESETS
from kubeinfer_tpu.inference import flash_attention as jfa
from kubeinfer_tpu.inference import init_params as jinit
from kubeinfer_tpu.inference import train as jtrain
from kubeinfer_tpu_torch.inference import flash_attention as tfa
from kubeinfer_tpu_torch.inference import model as tm
from kubeinfer_tpu_torch.inference import sharding as tsh
from kubeinfer_tpu_torch.inference import train as ttrain
from kubeinfer_tpu_torch.inference.config import PRESETS
from kubeinfer_tpu_torch.inference.weights import params_from_reference

CFG, JCFG = PRESETS["tiny"], JPRESETS["tiny"]


def tokens(B=1, T=17, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG.vocab_size, (B, T)).astype(np.int32)


def jax_flash(q, k, v, mask):
    B, S = q.shape[0], k.shape[1]
    return jfa.flash_attention_causal_diff(
        True, q, k, v, 0, jnp.full((B,), S, jnp.int32))


def port_flash(q, k, v, mask):
    B, S = q.shape[0], k.shape[1]
    return tfa.flash_attention_causal_diff(
        q, k, v, 0, torch.full((B,), S, dtype=torch.int32))


def port_params(tree):
    return params_from_reference(tree, "cpu")


@pytest.fixture(scope="module")
def small_tiles():
    mp = pytest.MonkeyPatch()
    for mod in (jfa, tfa):
        mp.setattr(mod, "TILE_T", 8)
        mp.setattr(mod, "TILE_S", 16)
    yield
    mp.undo()


@pytest.fixture(scope="module")
def reference(small_tiles):
    """The reference's weights (numpy), and per route its loss and
    gradient tree; the parameters after one ``train_step`` (dense)."""
    tree = jax.tree.map(np.asarray, jinit(JCFG, jax.random.PRNGKey(0)))
    toks = jnp.asarray(tokens())
    out = {"tree": tree}
    for route, fn in (("dense", None), ("flash", jax_flash)):
        loss, grads = jax.value_and_grad(jtrain.causal_lm_loss)(
            jax.tree.map(jnp.asarray, tree), toks, JCFG, fn)
        out[route] = (float(loss), jax.tree.map(np.asarray, grads))
    stepped, loss = jtrain.train_step(jax.tree.map(jnp.asarray, tree), toks,
                                      JCFG)
    out["step"] = (float(loss), jax.tree.map(np.asarray, stepped))
    return out


def assert_tree_close(got, want_tree, atol):
    want = ttrain._leaves(port_params(want_tree))
    got = ttrain._leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=atol,
                                   rtol=0)


def test_forward_default_routes_as_the_reference(monkeypatch):
    """No caches and no attn_fn: ``causal_attention_auto`` on every layer
    (the reference's binding), which on the CPU is the dense path
    bitwise; with caches or an explicit attn_fn it is not called."""
    params = tm.init_params(CFG, seed=0, device="cpu")
    toks = torch.from_numpy(tokens(2, 16)).long()
    calls = []
    auto = tfa.causal_attention_auto

    def spy(q, k, v, mask):
        calls.append(tuple(mask.shape))
        return auto(q, k, v, mask)

    monkeypatch.setattr(tfa, "causal_attention_auto", spy)
    got = tm.forward(params, toks, CFG)[0]
    assert calls == [(2, 16, 16)] * CFG.num_hidden_layers
    mask = tm.causal_mask(16)[None].expand(2, 16, 16)
    want = tm.forward(params, toks, CFG, attn_mask=mask,
                      attn_fn=tm.attention)[0]
    assert torch.equal(got, want)
    assert len(calls) == CFG.num_hidden_layers


@pytest.mark.parametrize("route", ["dense", "flash"])
def test_loss_and_grads_match_reference(reference, route):
    params = port_params(reference["tree"])
    leaves = ttrain._leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = ttrain.causal_lm_loss(params, torch.from_numpy(tokens()), CFG,
                                 port_flash if route == "flash" else None)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want_grads = reference[route]
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-6)
    assert_tree_close(list(grads), want_grads, atol=1e-5)


def test_train_step_matches_reference(reference):
    params = port_params(reference["tree"])
    before, tree_id = ttrain._leaves(params), id(params)
    out, loss = ttrain.train_step(params, torch.from_numpy(tokens()), CFG)
    assert id(out) == tree_id  # the same tree, updated in place
    assert all(a is b for a, b in zip(ttrain._leaves(out), before))
    assert not any(p.requires_grad for p in before)
    want_loss, want_tree = reference["step"]
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    assert_tree_close(out, want_tree, atol=1e-7)


def test_train_step_default_takes_the_flash_route(reference, monkeypatch):
    """Where ``flash_available`` holds (forced here: the CPU never
    qualifies), the default binding runs #13 forward and #14 backward,
    once per layer each, and matches the reference's flash gradients."""
    counts = dict.fromkeys(("flash_ragged_lse", "flash_bwd_dq",
                            "flash_bwd_dkv"), 0)
    for name in counts:
        fn = getattr(tfa, name)

        def counted(*a, _fn=fn, _name=name):
            counts[_name] += 1
            return _fn(*a)

        monkeypatch.setattr(tfa, name, counted)
    monkeypatch.setattr(tfa, "flash_available", lambda *a: True)
    params = port_params(reference["tree"])
    _, loss = ttrain.train_step(params, torch.from_numpy(tokens()), CFG,
                                lr=0.0)
    assert counts == dict.fromkeys(counts, CFG.num_hidden_layers)
    np.testing.assert_allclose(float(loss), reference["flash"][0], rtol=1e-6)


def test_loss_decreases_on_overfit_batch():
    """The mirror of ``TestTrainStep.test_loss_decreases_on_overfit_batch``
    on the port: 8 steps at lr 5e-2 over one batch."""
    params = tm.init_params(CFG, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, CFG.vocab_size, (4, 16)))
    first = float(ttrain.causal_lm_loss(params, toks, CFG))
    for _ in range(8):
        params, loss = ttrain.train_step(params, toks, CFG, lr=5e-2)
    assert float(loss) < first * 0.9


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sgd_matches_reference(dtype):
    rng = np.random.default_rng(4)
    shapes = [(64, 128), (256, 64), (64,)]
    ps = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jtrain._sgd([jnp.asarray(p).astype(dtype) for p in ps],
                       [jnp.asarray(g).astype(dtype) for g in gs], 1e-3)
    tdt = getattr(torch, dtype)
    got = ttrain._sgd([torch.from_numpy(p).to(tdt) for p in ps],
                      [torch.from_numpy(g).to(tdt) for g in gs], 1e-3)
    for g, w in zip(got, want):
        assert g.dtype == tdt
        g32, w32 = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == "float32":
            np.testing.assert_array_equal(g32, w32)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.abs(w32) + 1e-30)) - 7)
            assert (np.abs(g32 - w32) <= ulp).all()


def test_unsupported_trees_and_steps_raise():
    """An int8 tree has no gradient: every step raises on it, and the
    sharded step also on a batch that does not split over dp."""
    def int8_tree():
        return tm.init_params(CFG, seed=0, device="cpu", weight_dtype="int8")

    toks = torch.from_numpy(tokens(4))
    with pytest.raises(ValueError, match="int8"):
        ttrain.train_step(int8_tree(), toks, CFG)
    mesh = tsh.make_inference_mesh(tp=2, sp=1, dp=4, devices=CPU8)
    with pytest.raises(ValueError, match="int8"):
        ttrain.sp_train_step(tsh.make_inference_mesh(tp=1, sp=2,
                                                     devices=CPU8[:2]),
                             CFG)(int8_tree(), toks)
    with pytest.raises(ValueError, match="int8"):
        ttrain.sharded_train_step(mesh, CFG)(int8_tree(), toks)
    dense = tm.init_params(CFG, seed=0, device="cpu")
    with pytest.raises(ValueError, match="divide by dp=4"):
        ttrain.sharded_train_step(mesh, CFG)(dense, torch.from_numpy(
            tokens(2)))


# --- the parallel steps (kubeinfer_tpu/inference/train.py:72-130) ----------
#
# Against the reference's on its 8 virtual CPU devices, at ``tiny``: the
# loss within 2e-5 and every updated leaf within 5e-6 absolute and 1e-4
# relative (the reference's own bounds, tests/test_inference_train.py:
# 52-54 and :97-100: the same math, sums in another order).

CPU8 = ["cpu"] * 8


def batch_np(B, T, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(1, CFG.vocab_size, (B, T)).astype(np.int32)


def assert_leaves_close(got_tree, want_tree):
    want = ttrain._leaves(port_params(jax.tree.map(np.asarray, want_tree)))
    got = ttrain._leaves(got_tree)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), w.numpy(), atol=5e-6,
                                   rtol=1e-4)


def test_sharded_train_step_matches_reference():
    """dp=4 x tp=2: the loss and the updated tree of one step."""
    from kubeinfer_tpu.inference import sharding as jsh

    toks = batch_np(4, 17, 2)
    tree = jax.tree.map(np.asarray, jinit(JCFG, jax.random.PRNGKey(1)))
    jmesh = jsh.make_inference_mesh(tp=2, sp=1, dp=4)
    jparams = jsh.shard_params(jax.tree.map(jnp.asarray, tree), jmesh, JCFG)
    jtoks = jax.device_put(jnp.asarray(toks), jax.sharding.NamedSharding(
        jmesh, jax.sharding.PartitionSpec("dp", None)))
    want_tree, want_loss = jtrain.sharded_train_step(jmesh, JCFG)(jparams,
                                                                   jtoks)

    mesh = tsh.make_inference_mesh(tp=2, sp=1, dp=4, devices=CPU8)
    params = tsh.shard_params(port_params(tree), mesh, CFG)
    before = [x for s in params.shards for x in ttrain._leaves(s)]
    out, loss = ttrain.sharded_train_step(mesh, CFG)(params,
                                                     torch.from_numpy(toks))
    assert out is params  # updated in place, on its placement
    assert all(a is b for a, b in zip(
        [x for s in out.shards for x in ttrain._leaves(s)], before))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5,
                               atol=2e-5)
    assert_leaves_close(tsh.unshard_params(out), want_tree)


def test_sp_train_step_matches_reference():
    """sp=2: the loss and the updated tree of one step at lr 1e-2 (the
    reference's ``test_sp_step_decreases_loss`` rate)."""
    from kubeinfer_tpu.inference import sharding as jsh

    toks = batch_np(2, 17, 1)
    tree = jax.tree.map(np.asarray, jinit(JCFG, jax.random.PRNGKey(1)))
    jmesh = jsh.make_inference_mesh(tp=1, sp=2)
    want_tree, want_loss = jtrain.sp_train_step(jmesh, JCFG, lr=1e-2)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(toks))

    mesh = tsh.make_inference_mesh(tp=1, sp=2, devices=CPU8[:2])
    params = port_params(tree)
    out, loss = ttrain.sp_train_step(mesh, CFG, lr=1e-2)(
        params, torch.from_numpy(toks))
    assert out is params
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-5,
                               atol=2e-5)
    assert_leaves_close(out, want_tree)
    # the sp loss is the dense loss of the same tree
    dense = ttrain.causal_lm_loss(out, torch.from_numpy(toks), CFG)
    sp_loss = ttrain.sp_causal_lm_loss(out, torch.from_numpy(toks), CFG,
                                       mesh)
    np.testing.assert_allclose(float(sp_loss), float(dense), rtol=1e-5)


def test_replicated_copies_stay_equal():
    """Rank 1 holding its own copies of the replicated leaves (as ranks
    on two cards do): 3 sharded steps keep every copy equal to rank 0's,
    and the tree equal, bitwise, to the one whose ranks share them."""
    mesh = tsh.make_inference_mesh(tp=2, sp=1, dp=1, devices=CPU8[:2])
    toks = torch.from_numpy(batch_np(2, 17, 3))
    shared = tsh.shard_params(tm.init_params(CFG, seed=2, device="cpu"),
                              mesh, CFG)
    specs = shared.specs
    split = tsh.ShardedParams(mesh=mesh, specs=specs, shards=tuple(
        tsh._map2(lambda s, x: x.clone(), specs, shard)
        for shard in shared.shards))
    step = ttrain.sharded_train_step(mesh, CFG, lr=5e-2)
    losses = []
    for _ in range(3):
        shared, l_shared = step(shared, toks)
        split, l_split = step(split, toks)
        losses.append(float(l_split))
        assert float(l_shared) == float(l_split)
    assert losses[-1] < losses[0]
    pairs0 = tsh._leaves(specs, split.shards[0])
    pairs1 = tsh._leaves(specs, split.shards[1])
    copies = 0
    for (spec, a), (_, b) in zip(pairs0, pairs1):
        if "tp" not in spec:
            assert a is not b and torch.equal(a, b)
            copies += 1
    assert copies > 0
    for x, y in zip(ttrain._leaves(tsh.unshard_params(split)),
                    ttrain._leaves(tsh.unshard_params(shared))):
        assert torch.equal(x, y)
