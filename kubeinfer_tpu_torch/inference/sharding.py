"""Tensor parallelism for the port: the device mesh, the Megatron
parameter specs and the continuous batcher's device layout.

Counterpart of ``kubeinfer_tpu/inference/sharding.py``, with its names.
The reference is single-controller SPMD: one process places arrays on a
mesh and GSPMD partitions the jitted programs, inserting the two psums
of a Megatron layer. The port keeps that shape with the collectives
written out:

- one process and one scheduler thread drive every rank;
- :class:`Mesh` is a small ``(dp, tp, sp)`` array of ``torch.device``s.
  ``make_inference_mesh(devices=None)`` takes every visible CUDA card; an
  explicit list may repeat a device (``["cpu"] * 8``, ``["cuda:0"] * 2``),
  the counterpart of XLA's forced host devices, so tests run tp on the
  CPU and one H100 runs a tp=2 mesh over ``cuda:0`` twice;
- :func:`shard_params` gives each tp rank its own contiguous copy of its
  shard of every sharded leaf (``param_specs``: column-parallel
  q/k/v/gate/up, row-parallel o/down, a vocabulary-sharded ``lm_head``;
  int8 leaves per ``expand_quant_specs``) and a copy of every replicated
  leaf on its device (:class:`ShardedParams`);
- the KV pool ``[num_blocks, bs, n_kv, D]`` splits along ``n_kv``
  (``EngineLayout.shard_state``): every rank holds its heads' slice of
  every block (:class:`Sharded`), so block ids stay logical and
  ``BlockPool``/``RadixCache`` never see the layout. Tables, offsets,
  sampling knobs and keys stay single, on the first rank's device;
- :func:`all_reduce` is the one home of the layer's collective: the rank
  partials of ``o_proj`` and ``down_proj`` summed in rank order on the
  first rank's device (in f32, cast once). :func:`gather_vocab`
  concatenates a vocabulary-sharded head's logits the same way.

``model.forward`` runs each rank's ``n_q / tp`` query heads, ``n_kv /
tp`` KV heads and ``F / tp`` MLP lanes on its own device, so the kernels
run per shard on plain local tensors (#9 and #10 in the per-request
engine, #11 or #12 in the batcher, #15 on every int8 projection). The
reference must pin its routers dense under GSPMD (``gspmd=True``), which
cannot split a Pallas call; the port's routers keep that flag for parity
and the sharded engine calls them with ``gspmd=False``. The kernels' launch
helpers make each rank's card the current CUDA device for its launch
(``flash_attention.on_device``), since one thread drives every rank.

Sequence parallelism (``forward_sequence_parallel``, and
``sp_engine.py`` for serving) runs on the same mesh: sp rank s's tp group
is ``devices[0, :, s]`` (:func:`sp_rank_params` places its copy of the
params there, or shares rank 0's where the devices are the same), and
``model.sp_forward`` rings the K/V blocks over the sp ranks.

Kept for the reference's names and its parity tests, with no caller in
the serving path: the chip-grid walk of :func:`order_devices_ici` (a
``torch.device`` has no ``coords``, so cards keep their enumeration
order), :func:`make_axis_mesh` (the pp and ep constructors),
:func:`forward_tensor_parallel` and :func:`param_specs_replicated`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from kubeinfer_tpu_torch.inference.config import ModelConfig

Params = dict


class P(tuple):
    """A partition spec: one mesh axis name (or None) per tensor dim, as
    ``jax.sharding.PartitionSpec``; a spec shorter than the tensor leaves
    the trailing dims whole."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


def order_devices_ici(devices) -> list:
    """Devices reordered along a boustrophedon walk of the chip grid so
    consecutive ranks are neighbours, the reference's rule word for word.
    A device without ``coords`` (every ``torch.device``, the tests' fake
    devices aside) keeps its enumeration order: there is no topology to
    read, and the stable order keeps layouts reproducible."""
    coords = [getattr(d, "coords", None) for d in devices]
    if any(c is None for c in coords):
        return list(devices)
    sizes = [max(c[i] for c in coords) + 1 for i in range(len(coords[0]))]

    def snake_rank(c) -> int:
        # dims slowest to fastest; a dim entered at an odd index reverses
        # the next-faster dim, which makes row ends adjacent
        rank, flip = 0, False
        for i in reversed(range(len(sizes))):
            v = (sizes[i] - 1 - c[i]) if flip else c[i]
            rank = rank * sizes[i] + v
            flip = (v % 2) == 1
        return rank

    return sorted(devices, key=lambda d: (snake_rank(d.coords),
                                          getattr(d, "core_on_chip", 0)))


def _object_array(items) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    arr[:] = list(items)
    return arr


def mesh_device_array(devices, dp: int, tp: int, sp: int) -> np.ndarray:
    """The ordered ``(dp, tp, sp)`` device array with consecutive ``tp``
    ranks on consecutive chain positions: filled ``(dp, sp, tp)`` and
    transposed, as the reference (the identity when sp == 1)."""
    ordered = order_devices_ici(devices)[: dp * tp * sp]
    return _object_array(ordered).reshape(dp, sp, tp).transpose(0, 2, 1)


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``; a CUDA device without an index is the
    first card (the index its tensors report)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def same_device(a, b) -> bool:
    return _device(a) == _device(b)


class Mesh:
    """The port's device mesh: an array of ``torch.device``s with named
    axes (``shape[axis]``, ``size``, ``axis_names``, ``devices``)."""

    def __init__(self, devices: np.ndarray, axis_names: tuple) -> None:
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axes "
                             f"{axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(axis_names, devices.shape))
        self.size = int(devices.size)

    def axis_devices(self, axis: str) -> list[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis, in
        rank order."""
        i = self.axis_names.index(axis)
        index = tuple(slice(None) if j == i else 0
                      for j in range(len(self.axis_names)))
        return list(self.devices[index])


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_inference_mesh(tp: int = 1, sp: int = 1, dp: int | None = None,
                        devices=None) -> Mesh:
    """``(dp, tp, sp)`` mesh (dp fills the rest), ordered so adjacent tp
    ranks sit on adjacent devices. ``devices=None`` means every visible
    CUDA card; an explicit list may repeat a device."""
    devices = (_visible_cards() if devices is None
               else [_device(d) for d in devices])
    if dp is None:
        dp = len(devices) // (tp * sp)
    n = dp * tp * sp
    if n > len(devices) or n < 1:
        raise ValueError(f"mesh dp={dp} tp={tp} sp={sp} needs {n} devices, "
                         f"have {len(devices)}")
    return Mesh(mesh_device_array(devices, dp, tp, sp), ("dp", "tp", "sp"))


def make_axis_mesh(axis_name: str, n: int, devices=None) -> Mesh:
    """1-D mesh over the first ``n`` devices in order (the pp/ep
    constructors' one place for the device-count check)."""
    devices = (_visible_cards() if devices is None
               else [_device(d) for d in devices])
    if n > len(devices):
        raise ValueError(f"{axis_name}={n} needs {n} devices, have "
                         f"{len(devices)}")
    return Mesh(_object_array(order_devices_ici(devices)[:n]), (axis_name,))


def param_specs(cfg: ModelConfig) -> Params:
    """The partition spec tree matching ``init_params``' layout
    (Megatron tp), the reference's. A MoE layer's experts split like the
    dense MLP (every expert's ``F / tp`` lanes a rank) with the router
    replicated; expert parallelism over ``ep`` is ``moe.moe_block_ep``."""
    layer = {
        "input_layernorm": P(),
        "post_attention_layernorm": P(),
        "q_proj": P(None, "tp"),  # column parallel: heads shard
        "k_proj": P(None, "tp"),
        "v_proj": P(None, "tp"),
        "o_proj": P("tp", None),  # row parallel: all-reduce after
    }
    if cfg.num_local_experts > 0:
        layer["moe"] = {
            "router": P(),
            "gate_proj": P(None, None, "tp"),
            "up_proj": P(None, None, "tp"),
            "down_proj": P(None, "tp", None),
        }
    else:
        layer["gate_proj"] = P(None, "tp")
        layer["up_proj"] = P(None, "tp")
        layer["down_proj"] = P("tp", None)
    if cfg.qkv_bias:  # biases follow their projection's output sharding
        layer["q_bias"] = P("tp")
        layer["k_bias"] = P("tp")
        layer["v_bias"] = P("tp")
    return {
        "embed_tokens": P(None, None),  # replicated
        "layers": [layer] * cfg.num_hidden_layers,
        "norm": P(),
        "lm_head": P(None, "tp"),  # vocabulary-sharded logits
    }


def _map2(fn, specs, tree):
    """``fn(spec, leaf)`` over ``tree`` where ``specs`` is a prefix of it
    (a spec meets a whole subtree, as ``jax.tree.map``'s prefix rule)."""
    if isinstance(specs, P):
        return fn(specs, tree)
    if isinstance(specs, dict):
        return {k: _map2(fn, specs[k], tree[k]) for k in tree}
    return [_map2(fn, s, t) for s, t in zip(specs, tree)]


def expand_quant_specs(specs: Params, params: Params) -> Params:
    """Grow a ``param_specs`` tree to match int8 leaves: the codes take
    the weight's spec, the f32 scale plane shards along the weight's OUT
    axis (so a row-parallel leaf's scale is replicated)."""

    def one(spec, leaf):
        if isinstance(leaf, dict) and "qw" in leaf:
            out_axis = spec[-1] if len(spec) else None
            return {"qw": spec, "scale": P(out_axis)}
        return spec

    return _map2(one, specs, params)


def _tp_dim(spec: P) -> int | None:
    return spec.index("tp") if "tp" in spec else None


def _leaves(specs, tree):
    """(spec, leaf) pairs of a spec tree matched against ``tree``."""
    out: list = []
    _map2(lambda s, x: out.append((s, x)), specs, tree)
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedParams:
    """A parameter tree placed on a mesh's tp ranks: ``shards[r]`` has the
    tree's layout with rank r's contiguous slice of every sharded leaf and
    a copy of every replicated leaf, all on ``devices[r]`` (ranks on one
    device share their replicated copies). ``specs`` is the expanded spec
    tree."""

    mesh: Mesh
    specs: Params
    shards: tuple

    @property
    def tp(self) -> int:
        return len(self.shards)

    @property
    def devices(self) -> list[torch.device]:
        return self.mesh.axis_devices("tp")

    @property
    def device(self) -> torch.device:
        """The first rank's device: the replicated activations, the
        gathered logits and the sampling live there."""
        return self.devices[0]

    def nbytes(self) -> int:
        """Bytes of the logical tree, as the reference's global arrays
        count them: a sharded leaf's pieces summed, a replicated leaf
        once."""
        total = 0
        per_rank = [_leaves(self.specs, s) for s in self.shards]
        for i, (spec, leaf) in enumerate(per_rank[0]):
            ranks = per_rank if _tp_dim(spec) is not None else per_rank[:1]
            total += sum(r[i][1].numel() * r[i][1].element_size()
                         for r in ranks)
        return total


def _copy_to(x: torch.Tensor, dev) -> torch.Tensor:
    """A contiguous copy of ``x`` (any strides) on ``dev``, in storage of
    its own."""
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    out.copy_(x)
    return out


def shard_params(params: Params, mesh: Mesh, cfg: ModelConfig
                 ) -> ShardedParams:
    """Place a parameter tree on the mesh's tp ranks per ``param_specs``
    (expanded for int8 leaves). Sharded params already on ``mesh`` come
    back as they are. Raises where a rank would split a head
    (``check_heads``) or a sharded dim does not divide by tp."""
    if isinstance(params, ShardedParams):
        if params.mesh is not mesh:
            raise ValueError("params are sharded on another mesh")
        return params
    check_heads(cfg, mesh.shape["tp"])
    specs = param_specs(cfg)
    if "lm_head" not in params:
        specs = dict(specs)
        specs.pop("lm_head")
    specs = expand_quant_specs(specs, params)
    devs = mesh.axis_devices("tp")
    tp = len(devs)
    # one copy of a replicated leaf per distinct device
    replicas: dict = {}

    def piece(r):
        def one(spec, x):
            dim = _tp_dim(spec)
            if dim is None:
                key = (id(x), _device(devs[r]))
                if key not in replicas:
                    replicas[key] = _copy_to(x, devs[r])
                return replicas[key]
            n = x.shape[dim]
            if n % tp:
                raise ValueError(f"dim {dim} of a {tuple(x.shape)} leaf "
                                 f"does not divide by tp={tp}")
            w = n // tp
            return _copy_to(x.narrow(dim, r * w, w), devs[r])
        return one

    shards = tuple(_map2(piece(r), specs, params) for r in range(tp))
    return ShardedParams(mesh=mesh, specs=specs, shards=shards)


def unshard_params(params: ShardedParams) -> Params:
    """The plain tree on the first rank's device: sharded leaves
    concatenated in rank order, replicated leaves taken from rank 0 (the
    reference's replicated placement of a draft, ``batching.py:1000``)."""
    dev = params.device
    per_rank = [_leaves(params.specs, s) for s in params.shards]
    it = iter(range(len(per_rank[0])))

    def one(spec, _x):
        i = next(it)
        dim = _tp_dim(spec)
        if dim is None:
            return per_rank[0][i][1].to(dev)
        return torch.cat([r[i][1].to(dev) for r in per_rank], dim=dim)

    return _map2(one, params.specs, params.shards[0])


class Sharded:
    """Per-rank pieces of one logical tensor split along ``axis`` (a
    negative dim, so leading dims may be indexed away): a KV pool, cache,
    tail or scale plane under tp. ``shape`` is the logical shape."""

    __slots__ = ("pieces", "axis")

    def __init__(self, pieces, axis: int) -> None:
        self.pieces = list(pieces)
        self.axis = axis

    def __getitem__(self, r: int) -> torch.Tensor:
        return self.pieces[r]

    def __len__(self) -> int:
        return len(self.pieces)

    def __iter__(self):
        return iter(self.pieces)

    @property
    def shape(self) -> torch.Size:
        s = list(self.pieces[0].shape)
        s[self.axis] = sum(p.shape[self.axis] for p in self.pieces)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.pieces[0].dtype

    @property
    def device(self) -> torch.device:
        return self.pieces[0].device

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` (the logical layout, any device) cut along ``axis`` into
        the pieces' widths, each on its piece's device."""
        out, lo = [], 0
        for p in self.pieces:
            w = p.shape[self.axis]
            out.append(x.narrow(self.axis % x.ndim, lo, w).to(p.device))
            lo += w
        return out


def split_tensor(x: torch.Tensor, axis: int, devices) -> Sharded:
    """``x`` split along ``axis`` into ``len(devices)`` equal contiguous
    pieces, piece r a copy on ``devices[r]``."""
    n = len(devices)
    w = x.shape[axis] // n
    return Sharded([_copy_to(x.narrow(axis % x.ndim, r * w, w), d)
                    for r, d in enumerate(devices)], axis)


def rank_piece(node, r: int):
    """Rank r's view of a cache entry: every :class:`Sharded` in a
    (nested) tuple replaced by its r-th piece."""
    if isinstance(node, Sharded):
        return node[r]
    if isinstance(node, tuple):
        return tuple(rank_piece(x, r) for x in node)
    return node


def all_reduce(parts: list[torch.Tensor]) -> torch.Tensor:
    """THE collective of the sharded forward (the reference's GSPMD
    psum): the rank partials summed in rank order on the first rank's
    device, in f32, cast once to their dtype."""
    dev = parts[0].device
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.to(dev).float()
    return acc.to(parts[0].dtype)


def gather_vocab(parts: list[torch.Tensor]) -> torch.Tensor:
    """A vocabulary-sharded head's logits, concatenated along V in rank
    order on the first rank's device."""
    dev = parts[0].device
    return torch.cat([p.to(dev) for p in parts], dim=-1)


def check_heads(cfg: ModelConfig, tp: int) -> None:
    """Every rank must own whole heads (``EngineLayout.check_model``'s
    rule and messages): tp divides n_q and n_kv."""
    if cfg.num_attention_heads % tp:
        raise ValueError(f"tp={tp} must divide num_attention_heads="
                         f"{cfg.num_attention_heads}")
    if cfg.num_key_value_heads % tp:
        raise ValueError(
            f"tp={tp} must divide num_key_value_heads="
            f"{cfg.num_key_value_heads} (KV pool shards along n_kv)")


@dataclasses.dataclass(frozen=True)
class EngineLayout:
    """Device layout of the continuous batcher: a mesh and the placements
    of its params and slot state.

    ``tp == 1`` is meshless: ``shard_params``/``shard_state`` return their
    inputs untouched and the engine runs the single-device tensors and
    code path. Under ``tp > 1`` params follow ``param_specs``, the pool
    ``[num_blocks, block_size, n_kv, D]`` splits along ``n_kv`` (with the
    int8 scales ``[num_blocks, n_kv]`` and tails ``[n, 2, bs, n_kv, D]``),
    and every other ``SlotState`` field stays single on the first rank's
    device.

    Token parity with tp=1 is by dominance, as in the reference: the
    all-reduce sums partial products in another order than the unsharded
    contraction, so logits may differ in the last ulps, while the
    position-folded sampling noise is the same under every layout."""

    tp: int = 1
    mesh: Mesh | None = None

    def __post_init__(self) -> None:
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if (self.mesh is None) != (self.tp == 1):
            raise ValueError(
                "EngineLayout carries a mesh exactly when tp > 1 "
                f"(tp={self.tp}, mesh={'set' if self.mesh else 'None'})")
        if self.mesh is not None and self.mesh.shape.get("tp") != self.tp:
            raise ValueError(f"tp={self.tp} but the mesh's tp axis is "
                             f"{self.mesh.shape.get('tp')}")

    @classmethod
    def build(cls, tp: int = 1, devices=None) -> "EngineLayout":
        """tp=1 stays meshless; tp>1 builds the serving mesh over
        ``devices`` (every visible card by default)."""
        if tp <= 1:
            return cls()
        return cls(tp=tp, mesh=make_inference_mesh(tp=tp, sp=1, dp=1,
                                                   devices=devices))

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def mesh_devices(self) -> int:
        """Devices under the layout (1 when unsharded): the
        ``kubeinfer_mesh_devices`` gauge."""
        return 1 if self.mesh is None else self.mesh.size

    @property
    def devices(self) -> list[torch.device]:
        """The tp ranks' devices, in rank order (empty when unsharded)."""
        return [] if self.mesh is None else self.mesh.axis_devices("tp")

    def check_model(self, cfg: ModelConfig) -> None:
        """Every rank must own whole heads; n_kv == tp (one KV head a
        rank) is the floor."""
        if self.sharded:
            check_heads(cfg, self.tp)

    def shard_params(self, params: Params, cfg: ModelConfig):
        """Place params per ``param_specs``; identity when unsharded."""
        if not self.sharded:
            return params
        return shard_params(params, self.mesh, cfg)

    def shard_state(self, state):
        """Split a ``stepper.SlotState``'s pool along ``n_kv`` over the tp
        ranks (the int8 pages, scales and tails likewise, with the
        per-layer lists as views of each rank's tensors); identity when
        unsharded. The other fields stay where they are."""
        if not self.sharded:
            return state
        devs = self.devices
        if state.quantized:
            pages = split_tensor(state.q8_pages, -2, devs)
            scales = split_tensor(state.q8_scales, -1, devs)
            tails = split_tensor(state.q8_tails, -2, devs)
            L = state.q8_pages.shape[1]

            def views(t, side):
                return [Sharded([p[side, l] for p in t], t.axis)
                        for l in range(L)]

            return dataclasses.replace(
                state, caches_k=views(pages, 0), caches_v=views(pages, 1),
                scales_k=views(scales, 0), scales_v=views(scales, 1),
                tails_k=views(tails, 0), tails_v=views(tails, 1),
                q8_pages=pages, q8_scales=scales, q8_tails=tails)
        return dataclasses.replace(
            state,
            caches_k=[split_tensor(c, -2, devs) for c in state.caches_k],
            caches_v=[split_tensor(c, -2, devs) for c in state.caches_v])


def forward_tensor_parallel(params, tokens: torch.Tensor, cfg: ModelConfig,
                            mesh: Mesh) -> torch.Tensor:
    """The standard forward over tp-sharded params (placed here when
    plain): each rank runs its heads and lanes, the two all-reduces a
    layer and the vocabulary gather join them. Logits [B, T, V] f32 on
    the first rank's device. The whole batch runs on the tp ranks at dp
    and sp index 0 (the reference splits the batch over dp; the logits
    are the same)."""
    from kubeinfer_tpu_torch.inference.model import forward

    sp = shard_params(params, mesh, cfg)
    logits, _ = forward(sp, tokens.to(sp.device), cfg)
    return logits


def sp_rank_params(params, mesh: Mesh, cfg: ModelConfig) -> list:
    """Each sp rank's params on its tp group ``devices[0, :, s]``: plain
    params (tp == 1) or ``ShardedParams`` on the mesh's sp rank 0 (placed
    here when plain). A rank whose devices are rank 0's shares its
    tensors; another gets its own copy."""
    from kubeinfer_tpu_torch.inference.model import params_to

    tp = mesh.shape.get("tp", 1)
    if tp > 1:
        params = shard_params(params, mesh, cfg)
    out = [params]
    for s in range(1, mesh.shape["sp"]):
        sub = Mesh(mesh.devices[:1, :, s:s + 1], mesh.axis_names)
        devs = sub.axis_devices("tp")
        if all(same_device(a, b) for a, b in
               zip(devs, mesh.axis_devices("tp"))):
            out.append(params)
        elif tp > 1:
            out.append(ShardedParams(
                mesh=sub, specs=params.specs,
                shards=tuple(params_to(sh, d)
                             for sh, d in zip(params.shards, devs))))
        else:
            out.append(params_to(params, devs[0]))
    return out


def forward_sequence_parallel(params, tokens: torch.Tensor,
                              cfg: ModelConfig, mesh: Mesh) -> torch.Tensor:
    """Causal LM logits [B, T, V] f32 with the SEQUENCE split over the
    mesh's ``sp`` ranks, on the first rank's device: each rank embeds its
    block at global positions, ``model.sp_forward`` runs the layers
    layer-major with ring attention, each rank's head runs on its block
    (tp inside each sp rank where the mesh has tp > 1). T must divide by
    sp."""
    from kubeinfer_tpu_torch.inference.model import lm_logits, sp_forward

    B, T = tokens.shape
    sp = mesh.shape["sp"]
    if T % sp:
        raise ValueError(f"sequence length {T} must divide by sp={sp}")
    T_loc = T // sp
    ranks = sp_rank_params(params, mesh, cfg)
    first = mesh.devices[0, 0, 0]
    blocks = [tokens[:, s * T_loc:(s + 1) * T_loc].to(mesh.devices[0, 0, s])
              for s in range(sp)]
    hidden = sp_forward(ranks, blocks, cfg)
    return torch.cat([lm_logits(p, x, cfg).to(first)
                      for p, x in zip(ranks, hidden)], dim=1)


def param_specs_replicated(cfg: ModelConfig, params: Params) -> Params:
    """The all-replicated spec tree of ``params`` (every leaf ``P()``),
    the reference's in_specs of its sp ``shard_map``."""
    if isinstance(params, dict):
        return {k: param_specs_replicated(cfg, v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [param_specs_replicated(cfg, v) for v in params]
    return P()
