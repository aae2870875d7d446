"""Int8 weights: load-time per-tile quantization and the fused
dequantizing matmul (kernel #15).

Counterpart of ``kubeinfer_tpu/inference/weight_quant.py``. A quantized
leaf is the dict ``{"qw": int8[in, out], "scale": f32[out]}`` in place of
the plain ``[in, out]`` projection. Only the seven projections of a
decoder layer quantize (``QUANT_LEAVES``); embeddings, norms, biases,
the vocabulary head and a Mixtral layer's ``moe`` subtree (router and
expert stacks) stay in the load dtype, as in the reference.

Quantization is symmetric absmax per out-column tile of ``DEFAULT_TILE``
columns (zero-padded, so a ragged last tile reduces over zeros that
cannot raise its absmax): scale = amax / 127, 1.0 for an all-zero tile,
repeated per column within its tile. The codes DIVIDE by the per-column
scale (``round(wf / scol)``), as the reference writes it; the KV pool's
``kv_blocks.quantize_blocks`` multiplies by the reciprocal instead. Each
mirrors its reference op for op, so the codes are bitwise the same.

Kernel #15 ``quant_matmul`` (reference ``quant_matmul`` :222, body
``_quant_matmul_kernel`` :189): ``x [M, K] @ qw [K, N]`` with the int8
codes converted to the activation type (exact: |q| <= 127), f32
accumulation, and ``acc * scale[n]`` cast once to x's dtype. Its plain
version ``quant_matmul_plain`` is the reference's CPU route
(``quant_matmul_dense``): ``((x.float() @ qw.float()) * scale)`` in f32,
cast once. The wrapper takes the plain version for a CPU tensor only;
for a CUDA tensor it launches ``csrc/quant_matmul_tc.cu`` (wgmma + TMA)
where ``qmm_route`` holds, else ``csrc/quant_matmul.cu``, or raises.
``quant_matmul.launches`` counts its launches, ``tc_launches`` those of
the tensor-core kernel; ``quant_matmul_split_plain`` mirrors that
kernel's split-K arithmetic (``qmm_tc_plan``).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from kubeinfer_tpu_torch.inference import flash_attention as fa
from kubeinfer_tpu_torch.inference.kv_blocks import device_scalar
from kubeinfer_tpu_torch.inference.sharding import ShardedParams

# the projections that route through the fused kernel
QUANT_LEAVES = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)

DEFAULT_TILE = 128


# --- quantization (load time) ------------------------------------------------


def quantize_weight(w: torch.Tensor, tile: int = DEFAULT_TILE) -> dict:
    """Per-out-tile symmetric absmax int8 of a 2-D ``[in, out]`` weight;
    returns the quantized-leaf dict on ``w``'s device."""
    if w.dim() != 2:
        raise ValueError(f"quantize_weight expects 2-D, got {tuple(w.shape)}")
    K, N = w.shape
    wf = w.float()
    nt = -(-N // tile)
    wp = F.pad(wf, (0, nt * tile - N))
    amax = wp.reshape(K, nt, tile).abs().amax(dim=(0, 2))
    scale = torch.where(amax > 0, amax / device_scalar(amax, 127.0),
                        torch.ones_like(amax))
    scol = scale.repeat_interleave(tile)[:N].contiguous()
    q = torch.clamp(torch.round(wf / scol[None, :]), -127.0, 127.0)
    return {"qw": q.to(torch.int8).contiguous(), "scale": scol}


def dequantize_weight(d: dict, dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_weight`` (int8 -> f32, times the scale in
    f32, cast last)."""
    return (d["qw"].float() * d["scale"].float()[None, :]).to(dtype)


def is_quant_leaf(v) -> bool:
    return isinstance(v, dict) and "qw" in v and "scale" in v


def quantize_layer(layer: dict, tile: int = DEFAULT_TILE) -> dict:
    """A new layer dict with every ``QUANT_LEAVES`` member quantized;
    norms, biases and the ``moe`` subtree pass through."""
    out = dict(layer)
    for name in QUANT_LEAVES:
        w = layer.get(name)
        if w is not None and not is_quant_leaf(w):
            out[name] = quantize_weight(w, tile=tile)
    return out


def params_weight_dtype(params: dict) -> str:
    """``"int8"`` when any projection leaf is quantized, else ``"bf16"``
    (the axis name, not a torch dtype); of sharded params, their rank
    trees'."""
    if isinstance(params, ShardedParams):
        params = params.shards[0]
    for layer in params.get("layers", ()):
        for name in QUANT_LEAVES:
            if is_quant_leaf(layer.get(name)):
                return "int8"
    return "bf16"


def quantize_params(params: dict, tile: int = DEFAULT_TILE) -> dict:
    """Quantize the projection leaves of a whole tree. Raises on a tree
    that is already quantized: scales re-derived from int8 codes would be
    silently wrong. Sharded params are refused too: a row-parallel
    leaf's scale is the absmax over every rank's rows, so quantize the
    plain tree before sharding it."""
    if isinstance(params, ShardedParams):
        raise ValueError("quantize params before sharding them (a "
                         "row-parallel scale spans every rank's rows)")
    if params_weight_dtype(params) == "int8":
        raise ValueError("params already weight-quantized "
                         "(double-quantize guard)")
    out = dict(params)
    out["layers"] = [quantize_layer(l, tile=tile) for l in params["layers"]]
    return out


def dequantize_params(params: dict, dtype=None) -> dict:
    """The plain tree of a quantized one (in ``dtype``, default the
    norms' dtype)."""
    if dtype is None:
        dtype = params["norm"].dtype
    out = dict(params)
    out["layers"] = [
        {k: dequantize_weight(v, dtype) if is_quant_leaf(v) else v
         for k, v in layer.items()}
        for layer in params["layers"]
    ]
    return out


# --- the matmul ----------------------------------------------------------------


def quant_matmul_plain(x: torch.Tensor, qw: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ qw [K, N]`` in f32 (exact products: int8, bf16 and
    f32 values all fit f32), times the per-column scale, cast once to
    x's dtype."""
    acc = torch.matmul(x.float(), qw.float())
    return (acc * scale.float()).to(x.dtype)


# the card's count of blocks the bf16 instantiation aims for: four per SM
# of an H100; K is split over blocks when the (M, N) tiles alone are fewer
SPLIT_TARGET_BLOCKS = 528


def mma_tiles(M: int) -> tuple[int, int, int]:
    """(BM, BN, BK) of the bf16 instantiation (csrc/quant_matmul.cu's
    launcher picks the same): a 16-row M tile for decode-sized M, so 8
    rows pay 2x on padding, not 8-16x; 64 rows up to an admit's 512; 128
    above."""
    if M <= 16:
        return 16, 128, 64
    return (64, 128, 32) if M <= 512 else (128, 128, 32)


def k_splits(M: int, N: int, K: int) -> int:
    """Blocks along K for the bf16 instantiation: enough (M, N, K) blocks
    to fill the card, each walking at least one K tile."""
    BM, BN, BK = mma_tiles(M)
    tiles = -(-N // BN) * -(-M // BM)
    return max(1, min(-(-K // BK), SPLIT_TARGET_BLOCKS // tiles))


# the tensor-core kernel's geometry (csrc/quant_matmul_tc.cu): 128 weight
# columns and 64-deep K stages a block, and x rows a block: at decode
# sizes the first of TC_DECODE_ROWS that holds M (TMA zero-fills the
# padding), above them 128 or 256
TC_BN = 128
TC_BK = 64
TC_DECODE_ROWS = (8, 16, 32, 64)
# blocks that fill an H100 SXM once (132 SMs, one block each): the wide
# 256-row blocks where their tiles alone fill it, and K split over blocks
# only while the tiles are fewer, each split at least TC_MIN_K_TILES
# stages deep (decode sizes, bound by bytes) or TC_MIN_K_TILES_WIDE
# (prefill sizes, where each split adds an f32 partial of 128 or 256 rows
# to the combine)
TC_BLOCKS = 132
TC_MIN_K_TILES = 4
TC_MIN_K_TILES_WIDE = 16


def qmm_route(x: torch.Tensor, qw: torch.Tensor) -> bool:
    """Whether #15's wrapper launches the tensor-core kernel
    (``csrc/quant_matmul_tc.cu``) for ``x [..., K] @ qw [K, N]``: bf16
    with K % 16 == 0 and N % 16 == 0 (TMA's 16-byte strides), x and qw
    16-byte aligned as given. Every other bf16 call (a ragged shape, an x
    view at an odd offset) launches ``csrc/quant_matmul.cu``'s mma.sync
    kernel, f32 its CUDA-core kernel. A static choice, not a fallback:
    the chosen kernel launches or the wrapper raises."""
    K, N = qw.shape
    return (x.dtype == torch.bfloat16 and K % 16 == 0 and N % 16 == 0
            and x.data_ptr() % 16 == 0 and qw.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=4096)
def qmm_tc_plan(M: int, N: int, K: int) -> tuple[int, int, int]:
    """(x rows a block, splits, 64-deep K tiles a split) of the
    tensor-core kernel for x [M, K] @ qw [K, N]; every split non-empty.
    The rule was read off device times of the llama-3-8b projections on
    an H100 (``chip_smoke.py --qmm``): 256-row blocks run about 1.4x the
    rate of 128-row ones where both fill the card; splitting K pays at
    decode sizes and where fewer than a wave of tiles would run."""
    n_tiles = -(-N // TC_BN)
    k_tiles = -(-K // TC_BK)
    if M <= TC_DECODE_ROWS[-1]:
        rows = next(r for r in TC_DECODE_ROWS if M <= r)
        min_per = TC_MIN_K_TILES
    else:
        rows = 256 if -(-M // 256) * n_tiles >= TC_BLOCKS else 128
        min_per = TC_MIN_K_TILES_WIDE
    tiles = -(-M // rows) * n_tiles
    splits = max(1, min(TC_BLOCKS // tiles, k_tiles // min_per))
    per = -(-k_tiles // splits)
    return rows, -(-k_tiles // per), per


def quant_matmul_split_plain(x: torch.Tensor, qw: torch.Tensor,
                             scale: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's arithmetic in plain PyTorch: f32 partial
    sums over the K ranges of ``qmm_tc_plan``, added in split order,
    times the scale, cast once (each partial's own sum runs in another
    order than the kernel's)."""
    K, N = qw.shape
    x2 = x.reshape(-1, K)
    _, splits, per = qmm_tc_plan(x2.shape[0], N, K)
    step = per * TC_BK
    total = None
    for z in range(splits):
        part = torch.matmul(x2[:, z * step:(z + 1) * step].float(),
                            qw[z * step:(z + 1) * step].float())
        total = part if total is None else total + part
    return (total * scale.float()).to(x.dtype).reshape(*x.shape[:-1], N)


# the tensor-core kernel's f32 split partials, one buffer per (device,
# stream) grown to the largest call: launches on one stream never overlap
_workspaces: dict = {}


def _tc_workspace(dev, stream: int, n: int) -> torch.Tensor:
    key = (dev, stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=dev)
        _workspaces[key] = buf
    return buf


def _call(lib, fn: str, dev, *args) -> None:
    with fa.on_device(dev):
        err = getattr(lib, fn)(*args)
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.error_string(err)}")


def quant_matmul(x: torch.Tensor, qw: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """#15 on the tensors' device: leading dims of ``x`` fold into M (the
    reference's ``quant_matmul_auto``). For CUDA tensors one launch:
    ``quant_matmul_tc_launch`` where ``qmm_route`` holds (split K combined
    in the same launch), else ``quant_matmul_launch`` (bf16 on mma.sync,
    f32 on the CUDA cores); for CPU tensors ``quant_matmul_plain``."""
    tc = qmm_route(x, qw)
    lib = fa._kernel_lib(x, "quant_matmul",
                         "quant_matmul_tc" if tc else "quant_matmul")
    if lib is None:
        return quant_matmul_plain(x, qw, scale)
    if x.dtype not in fa._DTYPES:
        raise ValueError(f"quant_matmul: the kernel takes float32 or "
                         f"bfloat16 activations, not {x.dtype}")
    K, N = qw.shape
    lead = x.shape[:-1]
    if x.shape[-1] != K:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)} @ qw "
                         f"{tuple(qw.shape)}")
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % 16:  # a view at an odd offset: the kernel loads 16 B
        x2 = x2.clone()
    M = x2.shape[0]
    dev = x.device
    fa._check_split((("x", x2, x.dtype, (M, K), 16),
                     ("qw", qw, torch.int8, (K, N), 16),
                     ("scale", scale, torch.float32, (N,), 4)), dev)
    # the raw handle of the current stream (not a Stream object): #15 runs
    # 224 times a llama-3-8b forward, on the host
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    out = torch.empty((M, N), dtype=x.dtype, device=dev)
    if tc:
        rows, splits, per = qmm_tc_plan(M, N, K)
        ws = tickets = None
        if splits > 1:
            ws = _tc_workspace(dev, stream, splits * M * N).data_ptr()
            tickets = fa._split_tickets(
                dev, stream, -(-M // rows) * -(-N // TC_BN)).data_ptr()
        _call(lib, "quant_matmul_tc_launch", dev, x2.data_ptr(),
              qw.data_ptr(), scale.data_ptr(), out.data_ptr(), ws, tickets,
              M, N, K, rows, splits, per, stream)
        quant_matmul.tc_launches += 1
    else:
        splits = k_splits(M, N, K) if x.dtype == torch.bfloat16 else 1
        # the split-K partial sums, reduced in split order by a second pass
        ws = torch.empty((splits, M, N) if splits > 1 else (1,),
                         dtype=torch.float32, device=dev)
        _call(lib, "quant_matmul_launch", dev, x2.data_ptr(),
              qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
              ws.data_ptr(), M, N, K, splits, fa._DTYPES[x.dtype], stream)
    quant_matmul.launches += 1
    return out.reshape(*lead, N)


quant_matmul.launches = 0
quant_matmul.tc_launches = 0


def wq_dot(x: torch.Tensor, w, *, gspmd: bool = False) -> torch.Tensor:
    """``x @ w`` for a projection leaf that may be plain or quantized:
    the one call site of every projection in ``model.decoder_layer``.
    ``gspmd=True`` is the reference's flag for a caller under a sharded
    jit: the dense route (``quant_matmul_plain``), no kernel. The port's
    tensor parallel forward calls it per tp rank on that rank's shard
    with ``gspmd=False``, so #15 runs on every shard (column-parallel
    leaves carry their out-axis slice of ``qw`` and ``scale``,
    row-parallel ones their in-axis slice of ``qw`` and the whole
    ``scale``)."""
    if is_quant_leaf(w):
        if gspmd:
            return quant_matmul_plain(x, w["qw"], w["scale"])
        return quant_matmul(x, w["qw"], w["scale"])
    return x @ w
