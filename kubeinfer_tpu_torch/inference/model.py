"""Decoder-only transformer (llama family) in PyTorch.

Counterpart of ``kubeinfer_tpu/inference/model.py``. Parameters are a
plain dict of tensors with the reference's tree names and its ``[in,
out]`` projection layout, so ``x @ W`` needs no transpose and weights
carry across as a rename-free copy (``weights.params_from_reference``).

The reference's dtype casts stay where they are, so bf16 rounds at the
same places: f32 norm statistics, cos/sin cast to the activation dtype
before the rotation, f32 attention scores and softmax, probabilities
cast to the value dtype before the PV product.

KV-cache writes are IN PLACE (``index_put_`` / slice assignment): the
reference's ``.at[...].set(...)`` is functional and XLA makes it in
place under donation, but eager PyTorch would copy the whole cache (or
the whole paged pool) on every step. Under the int8 pool the step's K/V
go to the slot's tail, never to the int8 pages.

Every projection goes through ``weight_quant.wq_dot``: a plain leaf is
``x @ w``, an int8 leaf (``init_params(weight_dtype="int8")``) kernel
#15.

Tensor parallelism (``sharding.py``): ``forward`` over
``sharding.ShardedParams`` runs each tp rank's ``n_q / tp`` query heads,
``n_kv / tp`` KV heads and ``F / tp`` MLP lanes (every expert's, in a
mixture-of-experts layer) on its own device against its own KV pieces
(``sharding.Sharded``). The replicated norm output goes to each rank,
the ``o_proj`` and ``down_proj`` (or expert-weighted) partials meet in
``sharding.all_reduce`` on the first rank's device, and a separate
``lm_head``'s logits are gathered along the vocabulary
(``sharding.gather_vocab``); tied embeddings give the full logits there.
The reference's ``tp_axis``/``tp_size`` (the manual tp of a
``shard_map`` body, which sees local shards) keep their names: set over
sharded params of that tp they run the same sharded layer.

Sequence parallelism (``sp_forward``): the reference runs each sp
device's whole forward in a ``shard_map`` body and meets the others in
ring attention. One process cannot run the ranks side by side, so the
port's sp forward is layer-major: each layer computes every sp rank's
q/k/v (and, under tp, every tp rank's heads of it), then the ring over
the sp ranks' blocks (``ring_attention``; a tp rank rings its own head
shard), then each rank's ``o_proj`` and MLP. ``_parallel_layer`` is that
body, and the tp forward is its one-sp-rank case.

Mixture-of-experts layers (Mixtral) carry a ``moe`` subtree and run
``moe.moe_block`` in place of the dense MLP.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.inference.config import ModelConfig
from kubeinfer_tpu_torch.inference.moe import init_moe_params, moe_block
from kubeinfer_tpu_torch.inference.ring_attention import ring_attention
from kubeinfer_tpu_torch.inference.sharding import (
    Sharded,
    ShardedParams,
    all_reduce,
    gather_vocab,
    rank_piece,
    same_device,
)
from kubeinfer_tpu_torch.inference.weight_quant import quantize_layer, wq_dot

Params = dict[str, Any]


# --- initialization --------------------------------------------------------


def init_params(
    cfg: ModelConfig, seed: int = 0, dtype=torch.float32, device=None,
    weight_dtype: str = "bf16",
) -> Params:
    """Random init (normal, 0.02 std, HF default) with the reference's
    tree layout, drawn from an explicit ``torch.Generator`` on
    ``device``. Its numbers differ from the reference's ``init_params``
    (which draws from ``jax.random``): the tests carry the reference's
    trees over with ``weights.params_from_reference`` instead.

    ``weight_dtype="int8"`` quantizes each layer's projections as the
    layer is built (``weight_quant.quantize_layer`` on the ``dtype``
    weights), so the full-precision model never exists whole on the
    device; ``"bf16"`` (the axis name: ``dtype`` sets the precision)
    leaves the tree plain."""
    if weight_dtype not in ("bf16", "int8"):
        raise ValueError(f"weight_dtype must be bf16|int8: {weight_dtype!r}")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))

    def dense(shape):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        w.normal_(0.0, 0.02, generator=gen)
        return w.to(dtype)

    H, Fd, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv_dim = cfg.num_key_value_heads * cfg.head_dim
    q_dim = cfg.num_attention_heads * cfg.head_dim
    norm_init = torch.zeros if cfg.rmsnorm_offset else torch.ones
    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = {
            "input_layernorm": norm_init((H,), dtype=dtype, device=dev),
            "post_attention_layernorm": norm_init((H,), dtype=dtype,
                                                  device=dev),
            "q_proj": dense((H, q_dim)),
            "k_proj": dense((H, kv_dim)),
            "v_proj": dense((H, kv_dim)),
            "o_proj": dense((q_dim, H)),
        }
        if cfg.num_local_experts > 0:  # Mixtral family: routed MLP
            layer["moe"] = init_moe_params(gen, H, Fd, cfg.num_local_experts,
                                           dtype=dtype, device=dev)
        else:
            layer["gate_proj"] = dense((H, Fd))
            layer["up_proj"] = dense((H, Fd))
            layer["down_proj"] = dense((Fd, H))
        if cfg.qkv_bias:  # Qwen2 family
            layer["q_bias"] = torch.zeros((q_dim,), dtype=dtype, device=dev)
            layer["k_bias"] = torch.zeros((kv_dim,), dtype=dtype, device=dev)
            layer["v_bias"] = torch.zeros((kv_dim,), dtype=dtype, device=dev)
        if weight_dtype == "int8":
            layer = quantize_layer(layer)
        layers.append(layer)
    params: Params = {
        "embed_tokens": dense((V, H)),
        "layers": layers,
        "norm": norm_init((H,), dtype=dtype, device=dev),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = dense((H, V))
    return params


def layer_param_template(cfg: ModelConfig) -> dict:
    """The key structure of ONE decoder layer (None leaves), the
    reference's: dense or ``moe`` MLP, qkv biases. Spec builders that
    cannot afford real params (``pipeline.stack_stage_params``' check)
    map over this instead of a hard-coded key list."""
    layer: dict = {
        "input_layernorm": None,
        "post_attention_layernorm": None,
        "q_proj": None,
        "k_proj": None,
        "v_proj": None,
        "o_proj": None,
    }
    if cfg.num_local_experts > 0:
        layer["moe"] = {"router": None, "gate_proj": None, "up_proj": None,
                        "down_proj": None}
    else:
        layer["gate_proj"] = None
        layer["up_proj"] = None
        layer["down_proj"] = None
    if cfg.qkv_bias:
        layer["q_bias"] = None
        layer["k_bias"] = None
        layer["v_bias"] = None
    return layer


def param_bytes(params: Params) -> int:
    """Bytes of every tensor in the tree (int8 codes and their scales
    under weight quantization); of sharded params or tensors, the logical
    tree's (``ShardedParams.nbytes``, every piece of a ``Sharded``)."""
    if isinstance(params, ShardedParams):
        return params.nbytes()
    if isinstance(params, Sharded):
        return sum(p.numel() * p.element_size() for p in params)
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(param_bytes(v) for v in params)
    return params.numel() * params.element_size()


def params_to(params: Params, device) -> Params:
    """The same tree with every tensor on ``device`` (no copy where it
    already lives there). Sharded params stay where their mesh placed
    them; ``device`` must be their first rank's."""
    if isinstance(params, ShardedParams):
        if not same_device(device, params.device):
            raise ValueError(f"params sharded from {params.device}, "
                             f"asked for {device}")
        return params
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


def params_dtype(params: Params) -> torch.dtype:
    if isinstance(params, ShardedParams):
        params = params.shards[0]
    return params["norm"].dtype


def engine_device(params: Params, device) -> torch.device:
    """The device an engine over ``params`` runs on: ``device`` resolved
    (None: the card); for sharded params their first rank's device, which
    ``device``, when given, must name."""
    if isinstance(params, ShardedParams):
        if device is not None and not same_device(resolve_device(device),
                                                  params.device):
            raise ValueError(f"params sharded from {params.device}, engine "
                             f"asked for {device}")
        return params.device
    return resolve_device(device)


def rank_devices(params: Params) -> list | None:
    """The tp ranks' devices of sharded params, else None."""
    return params.devices if isinstance(params, ShardedParams) else None


# --- building blocks -------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             offset: bool = False) -> torch.Tensor:
    """RMSNorm with f32 statistics regardless of activation dtype;
    ``offset`` is the Gemma (1 + w) gain convention."""
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    w = weight.float()
    if offset:
        w = 1.0 + w
    return ((xf * scale) * w).to(x.dtype)


def _mlp_act(cfg: ModelConfig):
    """SwiGLU (silu) for llama/qwen2, tanh-approximate GeGLU for gemma."""
    if cfg.hidden_act == "silu":
        return F.silu
    if cfg.hidden_act == "gelu_pytorch_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unsupported hidden_act {cfg.hidden_act!r}")


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) f32 tables for rotary embeddings at positions [B, T]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    # device scalars made with full(): no host-to-device copy (a copy
    # from pageable memory would synchronise the host)
    inv_freq = 1.0 / torch.pow(
        torch.full((), theta, dtype=torch.float32, device=positions.device),
        exps,
    )
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate [B, T, heads, D] by [B, T, D/2] tables, HF llama halves."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(
    q: torch.Tensor,  # [B, T, n_heads, D]
    k: torch.Tensor,  # [B, S, n_kv, D]
    v: torch.Tensor,  # [B, S, n_kv, D]
    mask: torch.Tensor,  # bool[B, T, S] True = attend
) -> torch.Tensor:
    """GQA scaled-dot-product attention, f32 scores and softmax,
    probabilities cast to v's dtype before the PV product."""
    B, T, n_heads, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, T, n_kv, n_heads // n_kv, D)
    # f32 operands: exact products, f32 accumulation (the reference's
    # preferred_element_type=f32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg.float(), k.float())
    # a divisor on the scores' device: true division, as the reference
    # (a CPU scalar would let the CUDA kernel multiply by a reciprocal)
    scores = scores / torch.sqrt(
        torch.full((), float(D), dtype=torch.float32, device=q.device))
    scores = scores.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", probs, v)
    return out.reshape(B, T, n_heads, D)


def _write_tail(tail: torch.Tensor, new: torch.Tensor,
                cache_offset: torch.Tensor) -> None:
    """The int8 pool's decode write: the step's K (or V) ``new`` [B, T,
    n_kv, D] into the slot's tail [B, 2, bs, n_kv, D], IN PLACE, at tail
    slot ``rel = pos // bs - offset // bs`` (0, or 1 for a window that
    crosses a block edge). A partial block never round-trips through
    int8: the stepper quantizes the tail into the pool once it fills.
    Inactive rows write into their own tails, which a (re)admit
    rewrites."""
    B, T = new.shape[:2]
    bs = tail.shape[2]
    rows = torch.arange(B, device=new.device)
    if T == 1:
        # rel is 0: the tail was pinned to offset // bs by the last commit
        tail.index_put_((rows, torch.zeros_like(rows), cache_offset % bs),
                        new[:, 0])
        return
    pos = cache_offset[:, None] + torch.arange(T, device=new.device)
    rel = pos // bs - (cache_offset // bs)[:, None]
    tail.index_put_((rows[:, None], rel, pos % bs), new)


def _write_cache(ck: torch.Tensor, new: torch.Tensor, cache_offset,
                 block_tables: torch.Tensor | None) -> None:
    """Write the step's K (or V) ``new`` [B, T, n_kv, D] into the cache
    IN PLACE: paged (through ``block_tables``), per-row offsets, or one
    scalar offset. The reference's dynamic_update_slice clamps the start
    so the update fits; so do the dense branches here."""
    B, T = new.shape[:2]
    rows = torch.arange(B, device=new.device)
    if block_tables is not None:
        if getattr(cache_offset, "ndim", 0) != 1:
            raise ValueError(
                "block_tables requires per-row cache_offset (prefill "
                "writes go through the engine's paged admit, not "
                "decoder_layer)"
            )
        bs = ck.shape[1]
        # rows of a retired slot carry an all-null table, so their write
        # lands in the sacrificial block 0, read by nobody (duplicate
        # indices there leave it nondeterministic, as in the reference)
        pos = cache_offset[:, None] + torch.arange(T, device=new.device)
        blk = block_tables[rows[:, None], pos // bs]
        ck.index_put_((blk, pos % bs), new)  # in place
    elif getattr(cache_offset, "ndim", 0) == 1:
        S = ck.shape[1]
        start = cache_offset.clamp(0, S - T)
        pos = start[:, None] + torch.arange(T, device=new.device)
        ck.index_put_((rows[:, None], pos), new)  # in place
    else:
        S = ck.shape[1]
        start = min(max(int(cache_offset), 0), S - T)
        ck[:, start:start + T] = new  # in place


def _qkv(layer: Params, h: torch.Tensor, cos, sin, cfg: ModelConfig,
         n_q: int, n_kv: int):
    """q/k/v of ``n_q`` and ``n_kv`` heads (a tp rank's share under tp)
    from the normed ``h``, RoPE applied to q and k."""
    B, T, _ = h.shape
    D = cfg.head_dim
    q = wq_dot(h, layer["q_proj"])
    k = wq_dot(h, layer["k_proj"])
    v = wq_dot(h, layer["v_proj"])
    if cfg.qkv_bias:  # Qwen2 family; o_proj stays bias-free
        q = q + layer["q_bias"]
        k = k + layer["k_bias"]
        v = v + layer["v_bias"]
    q = apply_rope(q.reshape(B, T, n_q, D), cos, sin)
    k = apply_rope(k.reshape(B, T, n_kv, D), cos, sin)
    return q, k, v.reshape(B, T, n_kv, D)


def _write_kv(kv_cache, k, v, cache_offset, block_tables):
    """Write the step's K/V into ``kv_cache`` (IN PLACE) and return what
    the attention reads: the caches, or (k, v) without a cache."""
    if kv_cache is None:
        return k, v
    ck, cv = kv_cache
    if isinstance(ck, tuple):
        # the int8 pool: (pages, scales, tail) per side; the paired
        # attn_fn unpacks the triples
        if block_tables is None or getattr(cache_offset, "ndim", 0) != 1:
            raise ValueError("the int8 pool is written through block "
                             "tables at per-row offsets")
        _write_tail(ck[2], k, cache_offset)
        _write_tail(cv[2], v, cache_offset)
    else:
        _write_cache(ck, k, cache_offset, block_tables)
        _write_cache(cv, v, cache_offset, block_tables)
    return ck, cv


def _attn_out(layer: Params, h: torch.Tensor, cos, sin, mask,
              cfg: ModelConfig, kv_cache, cache_offset, attn_fn,
              block_tables) -> torch.Tensor:
    """The attention half of a block after its norm: q/k/v, the cache
    write, the attention and ``o_proj``."""
    B, T, _ = h.shape
    n_q = cfg.num_attention_heads
    q, k, v = _qkv(layer, h, cos, sin, cfg, n_q, cfg.num_key_value_heads)
    k, v = _write_kv(kv_cache, k, v, cache_offset, block_tables)
    attn = attn_fn(q, k, v, mask)
    return wq_dot(attn.reshape(B, T, n_q * cfg.head_dim), layer["o_proj"])


def _mlp_out(layer: Params, h: torch.Tensor, cfg: ModelConfig
             ) -> torch.Tensor:
    """The MLP half after its norm (a tp rank's lanes and partial under
    tp): the gated MLP, or the ``moe`` block (every expert's lanes of the
    rank; the replicated router sees the whole ``h``, so the gating is
    the same on every rank and one all-reduce after the expert-weighted
    sum completes it)."""
    if "moe" in layer:  # Mixtral family
        return moe_block(layer["moe"], h, top_k=cfg.num_experts_per_tok)
    gate = _mlp_act(cfg)(wq_dot(h, layer["gate_proj"]))
    return wq_dot(gate * wq_dot(h, layer["up_proj"]), layer["down_proj"])


def decoder_layer(
    layer: Params,
    x: torch.Tensor,  # [B, T, H]
    cos: torch.Tensor,
    sin: torch.Tensor,
    mask,
    cfg: ModelConfig,
    kv_cache: tuple[torch.Tensor, torch.Tensor] | None = None,
    cache_offset=0,
    attn_fn=attention,
    tp_axis: str | None = None,
    tp_size: int = 1,
    block_tables: torch.Tensor | None = None,
):
    """One pre-norm block; returns (x, kv cache or None). With a cache,
    the step's K/V are written into it in place (see ``_write_cache``)
    and attention reads the whole cache. ``tp_axis`` (the reference's
    manual tp of one device's shards) needs every rank's layer to meet
    in the all-reduce: run it through ``forward`` over sharded params."""
    if tp_axis is not None:
        raise ValueError(
            f"tp_axis={tp_axis!r} (tp_size={tp_size}) runs over "
            "sharding.ShardedParams in forward; decoder_layer takes one "
            "plain layer")
    h = rms_norm(x, layer["input_layernorm"], cfg.rms_norm_eps,
                 offset=cfg.rmsnorm_offset)
    x = x + _attn_out(layer, h, cos, sin, mask, cfg, kv_cache, cache_offset,
                      attn_fn, block_tables)
    h = rms_norm(x, layer["post_attention_layernorm"], cfg.rms_norm_eps,
                 offset=cfg.rmsnorm_offset)
    x = x + _mlp_out(layer, h, cfg)
    return x, kv_cache


def _on_ranks(t, devices) -> list:
    """``t`` on each rank's device (the same object where it already
    lives there; a non-tensor passes through)."""
    if not isinstance(t, torch.Tensor):
        return [t] * len(devices)
    moved: dict = {}
    out = []
    for d in devices:
        if same_device(d, t.device):
            out.append(t)
        else:
            key = str(d)
            if key not in moved:
                moved[key] = t.to(d)
            out.append(moved[key])
    return out


def _rank_tree(params) -> Params:
    """The tree whose replicated leaves a forward reads: rank 0's."""
    return params.shards[0] if isinstance(params, ShardedParams) else params


def _rank_layers(params, i: int) -> list:
    """Layer ``i`` of each tp rank (one entry for plain params)."""
    if isinstance(params, ShardedParams):
        return [s["layers"][i] for s in params.shards]
    return [params["layers"][i]]


def _reduce(parts: list) -> torch.Tensor:
    """The tp ranks' partials summed (one rank: its own)."""
    return parts[0] if len(parts) == 1 else all_reduce(parts)


def _parallel_layer(ranks: list, i: int, xs: list, ops: list,
                    cfg: ModelConfig, caches: list, attend) -> list:
    """Block ``i`` layer-major over sp ranks x tp ranks. ``ranks[s]`` are
    sp rank s's params (plain, or sharded over its tp group), ``xs[s]``
    its activations on its first device, ``ops[s][r]`` (cos, sin, mask,
    cache_offset, block_tables) on tp rank r's device, ``caches[s]`` its
    layer-``i`` cache entry or None. Every (s, r) computes its q/k/v and
    writes its cache; ``attend(qs, ks, vs, masks)`` (one tp rank's, a
    list over s each) gives every sp rank's attention output; the
    ``o_proj`` and MLP partials meet in one all-reduce each per sp
    rank."""
    S = len(xs)
    tp = len(ops[0])
    n_q = cfg.num_attention_heads // tp
    n_kv = cfg.num_key_value_heads // tp
    layers = [_rank_layers(p, i) for p in ranks]
    devs = [[o[0].device for o in ops[s]] for s in range(S)]
    qkv = []
    for s, x in enumerate(xs):
        h = rms_norm(x, layers[s][0]["input_layernorm"], cfg.rms_norm_eps,
                     offset=cfg.rmsnorm_offset)
        row = []
        for r, hr in enumerate(_on_ranks(h, devs[s])):
            cos, sin, _, offset, tables = ops[s][r]
            q, k, v = _qkv(layers[s][r], hr, cos, sin, cfg, n_q, n_kv)
            cache = None if caches[s] is None else rank_piece(caches[s], r)
            row.append((q, *_write_kv(cache, k, v, offset, tables)))
        qkv.append(row)
    attn = [attend(*([qkv[s][r][j] for s in range(S)] for j in range(3)),
                   [ops[s][r][2] for s in range(S)]) for r in range(tp)]
    out = []
    for s, x in enumerate(xs):
        B, T, _ = x.shape
        x = x + _reduce([wq_dot(attn[r][s].reshape(B, T, n_q * cfg.head_dim),
                                layers[s][r]["o_proj"]) for r in range(tp)])
        h = rms_norm(x, layers[s][0]["post_attention_layernorm"],
                     cfg.rms_norm_eps, offset=cfg.rmsnorm_offset)
        out.append(x + _reduce([_mlp_out(layers[s][r], hr, cfg) for r, hr
                                in enumerate(_on_ranks(h, devs[s]))]))
    return out


# --- full forward ----------------------------------------------------------


def causal_mask(T: int, device=None) -> torch.Tensor:
    return torch.tril(torch.ones((T, T), dtype=torch.bool, device=device))


def embed(tree: Params, tokens: torch.Tensor, cfg: ModelConfig
          ) -> torch.Tensor:
    """The token embeddings; Gemma's sqrt(H) normalizer is cast to the
    activation dtype before the multiply, as in the HF reference."""
    x = tree["embed_tokens"][tokens]
    if cfg.scale_embeddings:
        x = x * float(torch.tensor(float(cfg.hidden_size) ** 0.5,
                                   dtype=x.dtype))
    return x


def forward(
    params: Params,
    tokens: torch.Tensor,  # i64/i32[B, T]
    cfg: ModelConfig,
    positions: torch.Tensor | None = None,  # [B, T]; default arange
    attn_mask: torch.Tensor | None = None,  # bool[B, T, S]
    kv_caches: list | None = None,
    cache_offset=0,
    attn_fn=None,
    tp_axis: str | None = None,
    tp_size: int = 1,
    return_hidden: bool = False,
    block_tables: torch.Tensor | None = None,
):
    """Logits [B, T, V] f32 (or post-norm hidden states with
    ``return_hidden``) and the caches, written in place.

    ``attn_fn=None`` means auto, as in the reference: the plain causal
    no-cache path (training, full-sequence prefill) binds
    ``flash_attention.causal_attention_auto``, which takes the
    differentiable flash route (#9, or #13/#14 under autograd) where
    ``flash_available`` holds and the dense ``attention`` over the causal
    mask otherwise; every other path gets the dense ``attention`` over
    ``attn_mask``. A caller that binds an ``attn_fn`` which derives its
    own mask (the kernel routers) may pass ``attn_mask=None`` with
    caches; the reference builds the dense mask there and lets XLA drop
    it.

    ``tp_axis``/``tp_size`` are the reference's manual tp: set, they need
    ``ShardedParams`` of ``tp == tp_size``, and run the same sharded
    layers that sharded params run without them."""
    B, T = tokens.shape
    dev = tokens.device
    sharded = isinstance(params, ShardedParams)
    if tp_axis is not None and not (sharded and params.tp == tp_size):
        raise ValueError(
            f"tp_axis={tp_axis!r} with tp_size={tp_size} needs params "
            f"sharded over tp={tp_size} (sharding.shard_params); got "
            + (f"tp={params.tp}" if sharded else "plain params"))
    if positions is None:
        base = torch.arange(T, dtype=torch.int64, device=dev)[None, :]
        if getattr(cache_offset, "ndim", 0) == 1:
            positions = base + cache_offset[:, None]
        else:
            positions = (base + int(cache_offset)).expand(B, T)
    if attn_mask is None:
        if kv_caches is not None and attn_fn is None:
            raise ValueError("decode with kv_caches requires attn_mask")
        if kv_caches is None:
            # the dense fallback operand of the auto route below
            attn_mask = causal_mask(T, dev)[None].expand(B, T, T)
            if attn_fn is None:
                # lazy import: flash_attention's dense fallback is this
                # module's ``attention``
                from kubeinfer_tpu_torch.inference.flash_attention import (
                    causal_attention_auto,
                )

                attn_fn = causal_attention_auto
    if attn_fn is None:
        attn_fn = attention

    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    # replicated leaves: rank 0's copies, on the first rank's device
    tree = _rank_tree(params)
    if sharded:
        ops = [list(zip(*(_on_ranks(t, params.devices) for t in (
            cos, sin, attn_mask, cache_offset, block_tables))))]

        def attend(qs, ks, vs, masks):
            return [attn_fn(qs[0], ks[0], vs[0], masks[0])]
    x = embed(tree, tokens, cfg)
    new_caches = [] if kv_caches is not None else None
    for i, layer in enumerate(tree["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        if sharded:
            x = _parallel_layer([params], i, [x], ops, cfg, [cache],
                                attend)[0]
        else:
            x, cache = decoder_layer(
                layer, x, cos, sin, attn_mask, cfg, kv_cache=cache,
                cache_offset=cache_offset, attn_fn=attn_fn,
                block_tables=block_tables,
            )
        if new_caches is not None:
            new_caches.append(cache)
    x = rms_norm(x, tree["norm"], cfg.rms_norm_eps,
                 offset=cfg.rmsnorm_offset)
    if return_hidden:
        return x, new_caches
    return lm_logits(params, x, cfg), new_caches


def sp_forward(ranks: list, tokens: list, cfg: ModelConfig,
               kv_caches: list | None = None) -> list:
    """The sequence-parallel forward, layer-major: ``tokens[s]`` [B, T_loc]
    is sp rank s's block (global positions ``s*T_loc + t``) on its first
    device, ``ranks[s]`` its params (plain, or sharded over its tp
    group), ``kv_caches[s]`` its local dense caches [B, T_loc, n_kv(/tp),
    D] a layer (``Sharded`` under tp), written at offset 0. Attention is
    ``ring_attention`` over the sp ranks, once for each tp rank's heads.
    Returns each rank's post-norm hidden states [B, T_loc, H]."""
    B, T_loc = tokens[0].shape
    ops, xs = [], []
    for s, (p, tok) in enumerate(zip(ranks, tokens)):
        pos = s * T_loc + torch.arange(T_loc, dtype=torch.int64,
                                       device=tok.device)
        cos, sin = rope_tables(pos[None, :].expand(B, T_loc), cfg.head_dim,
                               cfg.rope_theta)
        devs = (p.devices if isinstance(p, ShardedParams)
                else [tok.device])
        ops.append([(c, sn, None, 0, None) for c, sn in
                    zip(_on_ranks(cos, devs), _on_ranks(sin, devs))])
        xs.append(embed(_rank_tree(p), tok, cfg))

    def attend(qs, ks, vs, _masks):
        return ring_attention(qs, ks, vs)

    for i in range(cfg.num_hidden_layers):
        caches = ([None] * len(xs) if kv_caches is None
                  else [c[i] for c in kv_caches])
        xs = _parallel_layer(ranks, i, xs, ops, cfg, caches, attend)
    return [rms_norm(x, _rank_tree(p)["norm"], cfg.rms_norm_eps,
                     offset=cfg.rmsnorm_offset) for p, x in zip(ranks, xs)]


def lm_head_matrix(params: Params, cfg: ModelConfig) -> torch.Tensor:
    """The [H, V] output projection (tied or separate)."""
    if cfg.tie_word_embeddings:
        return params["embed_tokens"].T
    return params["lm_head"]


def lm_logits(params: Params, x: torch.Tensor, cfg: ModelConfig
              ) -> torch.Tensor:
    """f32 logits of post-norm hidden states ``x`` [..., H]. Under tp a
    separate head is vocabulary-sharded: each rank's slice of the logits,
    gathered in rank order on the first rank's device; a tied head is
    the replicated embedding, on the first rank's device."""
    if not isinstance(params, ShardedParams):
        return (x @ lm_head_matrix(params, cfg)).float()
    if cfg.tie_word_embeddings:
        return (x @ params.shards[0]["embed_tokens"].T).float()
    return gather_vocab([(xr @ shard["lm_head"]).float() for shard, xr in
                         zip(params.shards, _on_ranks(x, params.devices))])
