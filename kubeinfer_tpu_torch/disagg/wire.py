"""KV-block wire format: one self-verifying blob per exported prefix.

Framing is a single JSON header line followed by the raw page bytes —
the same shape as transfer.py's model plane (text metadata + opaque
body, sha256 over the body), chosen so a torn or truncated stream is
always detectable before any page reaches a pool. The header carries
everything an importer must agree on BEFORE scattering: dtype, page
shape, block size, and the rolling prefix fingerprints that
content-address each block (kv_blocks.prefix_fingerprints — both sides
chain the identical FNV function, so a fingerprint match proves the
exporter computed these pages for exactly this token prefix).

Pages travel as two dense arrays, ``[layers, blocks, *page_shape]`` for
K then V. Block ids never cross the wire — they are pool-local on both
ends; position in the array IS the logical index. No tensor-parallel
metadata either: pages are whole along every axis (the exporter
gathers replicated logical blocks, the importer scatters into its own
layout), per the package's layout audit.

Version 2 (``kubeinfer-kvwire/2``) carries quantized pools: the body
grows two ``[layers, blocks, n_kv]`` float32 scale arrays (K then V)
after the pages, and the header names the pool's ``kv_dtype``. bf16
exporters keep emitting v1 byte-identically — the new magic appears on
the wire only when scales do, so a pre-quantization fleet never sees
an unknown header field mid-rollout. Decoders accept both versions;
dtype agreement is the IMPORTER's policy call (client.py), not a wire
error: a v1 blob is a valid payload that an int8 engine must decline,
not corruption.

Version 3 (``kubeinfer-kvwire/3``) adds ``start_block`` for CHUNKED
transfers (live-session migration): the payload's pages cover blocks
``[start_block, start_block + blocks)`` of a longer chain, and its
fingerprints are that SLICE of the chain — each one still rolls over
the full prefix from token 0, so a chunk is only importable on top of
the exact prefix it continues. Deliberately no total-blocks field: the
importer computes the full chain from its own tokens and verifies the
slice against it; a header field would just be a second, spoofable
copy. Chunk 0 of a chunked stream has ``start_block == 0`` and encodes
as plain v1/v2 (decoders default the field to 0), so the v1
byte-identity pin and every pre-v3 importer keep working; the v3 magic
appears on the wire only when a nonzero offset does.

A copy of ``kubeinfer_tpu/disagg/wire.py`` for the PyTorch port, byte
for byte on the wire. Pages are CPU torch tensors (numpy arrays of
standard dtypes are taken too): the header's ``dtype`` is the element
type's numpy name, the body is each tensor's raw bytes in C order, and
``decode_payload`` maps the names it knows (``bfloat16``, ``float16``,
``float32``, ``int8``) to torch dtypes itself; any other name is a
``WireError``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np
import torch

_MAGIC = "kubeinfer-kvwire/1"
_MAGIC_V2 = "kubeinfer-kvwire/2"
_MAGIC_V3 = "kubeinfer-kvwire/3"

# Header stays a bounded parse even against a hostile peer: fingerprint
# lists are capped by pool size in practice (blocks <= num_blocks), but
# a corrupt length field must not make us allocate the body blindly.
_MAX_HEADER_BYTES = 1 << 20

# the wire's dtype names (numpy's, as the reference writes them)
_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "int8": torch.int8,
}
_NAMES = {dt: name for name, dt in _DTYPES.items()}


class WireError(RuntimeError):
    """Malformed, truncated, or checksum-failed KV payload."""


@dataclasses.dataclass(frozen=True)
class KVBlockPayload:
    """Decoded KV export: ``pages_k``/``pages_v`` are
    ``[layers, blocks, block_size, n_kv_heads, head_dim]`` CPU tensors;
    ``fingerprints[i]`` content-addresses the prefix through block i."""

    pages_k: torch.Tensor
    pages_v: torch.Tensor
    fingerprints: tuple[int, ...]
    block_size: int
    # v2 fields: kv_dtype is the exporter's pool dtype ("bf16"/"int8");
    # scales are [layers, blocks, n_kv] float32, present iff int8.
    kv_dtype: str = "bf16"
    scales_k: torch.Tensor | None = None
    scales_v: torch.Tensor | None = None
    # v3 field: first block's offset in the full chain this chunk
    # continues (0 = the chain's head, which also encodes as v1/v2)
    start_block: int = 0

    @property
    def blocks(self) -> int:
        return int(self.pages_k.shape[1])

    @property
    def byte_size(self) -> int:
        n = _nbytes(self.pages_k) + _nbytes(self.pages_v)
        if self.scales_k is not None:
            n += _nbytes(self.scales_k) + _nbytes(self.scales_v)
        return n


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _host(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (a torch tensor, or a numpy array of a
    standard dtype)."""
    if isinstance(x, np.ndarray):
        try:
            return torch.from_numpy(np.ascontiguousarray(x))
        except TypeError as e:
            raise WireError(f"unsupported array dtype {x.dtype}") from e
    if not isinstance(x, torch.Tensor):
        raise WireError(f"pages must be tensors, got {type(x).__name__}")
    return x.detach().cpu()


def _raw(t: torch.Tensor) -> memoryview:
    """The tensor's bytes in C order, without a copy where it is
    contiguous."""
    flat = t.contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


def encode_payload(
    pages_k,
    pages_v,
    fingerprints: list[int] | tuple[int, ...],
    block_size: int,
    scales_k=None,
    scales_v=None,
    kv_dtype: str = "bf16",
    start_block: int = 0,
) -> bytes:
    if start_block < 0:
        raise WireError(f"start_block must be >= 0, got {start_block}")
    pages_k, pages_v = _host(pages_k), _host(pages_v)
    if pages_k.shape != pages_v.shape or pages_k.dtype != pages_v.dtype:
        raise WireError(
            f"K/V pages disagree: {tuple(pages_k.shape)}/{pages_k.dtype} vs "
            f"{tuple(pages_v.shape)}/{pages_v.dtype}"
        )
    if pages_k.ndim != 5:
        raise WireError(
            f"pages must be [layers, blocks, bs, n_kv, D], got "
            f"shape {tuple(pages_k.shape)}"
        )
    if len(fingerprints) != pages_k.shape[1]:
        raise WireError(
            f"{len(fingerprints)} fingerprints for "
            f"{pages_k.shape[1]} blocks"
        )
    if (scales_k is None) != (scales_v is None):
        raise WireError("scales_k/scales_v must travel together")
    if (kv_dtype != "bf16") != (scales_k is not None):
        raise WireError(
            f"kv_dtype {kv_dtype!r} inconsistent with "
            f"scales {'present' if scales_k is not None else 'absent'}"
        )
    name = _NAMES.get(pages_k.dtype)
    if name is None:
        raise WireError(f"unsupported page dtype {pages_k.dtype}")
    parts = [_raw(pages_k), _raw(pages_v)]
    header = {
        "magic": _MAGIC,
        "dtype": name,
        "layers": int(pages_k.shape[0]),
        "blocks": int(pages_k.shape[1]),
        "page_shape": [int(d) for d in pages_k.shape[2:]],
        "block_size": int(block_size),
        "fingerprints": [int(fp) for fp in fingerprints],
    }
    if scales_k is not None:
        # Scale shape is derivable ([layers, blocks, n_kv]) but checked
        # here so a malformed export fails at the producer, where the
        # engine state is still inspectable, not at a remote importer.
        want = (pages_k.shape[0], pages_k.shape[1], pages_k.shape[3])
        scales = []
        for sname, s in (("scales_k", scales_k), ("scales_v", scales_v)):
            s = _host(s)
            if tuple(s.shape) != want or s.dtype != torch.float32:
                raise WireError(
                    f"{sname} must be float32 {want}, got "
                    f"{s.dtype} {tuple(s.shape)}"
                )
            scales.append(_raw(s))
        parts += scales
        header["magic"] = _MAGIC_V2
        header["kv_dtype"] = kv_dtype
    if start_block:
        # v3 only when the offset carries information: chunk 0 and
        # whole-prefix exports keep the v1/v2 magic (and the v1
        # byte-identity pin) — decoders default start_block to 0
        header["magic"] = _MAGIC_V3
        header["kv_dtype"] = kv_dtype
        header["start_block"] = int(start_block)
    sha = hashlib.sha256()
    for p in parts:
        sha.update(p)
    header["body_bytes"] = sum(p.nbytes for p in parts)
    header["body_sha256"] = sha.hexdigest()
    return b"".join([json.dumps(header).encode(), b"\n", *parts])


def decode_payload(blob: bytes) -> KVBlockPayload:
    nl = blob.find(b"\n", 0, _MAX_HEADER_BYTES)
    if nl < 0:
        raise WireError("no header line within bound")
    try:
        header = json.loads(blob[:nl])
    except ValueError as e:
        raise WireError(f"header is not JSON: {e}") from e
    if not isinstance(header, dict):
        raise WireError("header is not an object")
    magic = header.get("magic")
    if magic not in (_MAGIC, _MAGIC_V2, _MAGIC_V3):
        raise WireError(f"bad magic {magic!r}")
    v3 = magic == _MAGIC_V3
    body = memoryview(blob)[nl + 1:]
    try:
        layers = int(header["layers"])
        blocks = int(header["blocks"])
        page_shape = tuple(int(d) for d in header["page_shape"])
        block_size = int(header["block_size"])
        fingerprints = tuple(int(fp) for fp in header["fingerprints"])
        body_bytes = int(header["body_bytes"])
        want_sha = str(header["body_sha256"])
        dtype_name = str(header["dtype"])
        kv_dtype = (
            str(header["kv_dtype"])
            if magic != _MAGIC else "bf16"
        )
        start_block = int(header["start_block"]) if v3 else 0
    except (KeyError, TypeError, ValueError) as e:
        raise WireError(f"malformed header: {e}") from e
    dtype = _DTYPES.get(dtype_name)
    if dtype is None:
        raise WireError(f"unresolvable dtype {dtype_name!r}")
    if magic == _MAGIC_V2 and kv_dtype == "bf16":
        raise WireError("v2 header claims bf16 — scales make no sense")
    if v3 and start_block <= 0:
        # a zero-offset v3 blob would be a second spelling of v1/v2
        # bytes for the same payload, splitting the content address
        raise WireError("v3 start_block must be > 0 (chunk 0 is v1/v2)")
    # scales ride iff the pool is quantized — v3 carries them under the
    # same rule as v2 (kv_dtype names the pool, bf16 chunks have none)
    scaled = kv_dtype != "bf16"
    if len(page_shape) != 3 or page_shape[0] != block_size:
        raise WireError(
            f"page_shape {page_shape} inconsistent with "
            f"block_size {block_size}"
        )
    if len(fingerprints) != blocks:
        raise WireError(
            f"{len(fingerprints)} fingerprints for {blocks} blocks"
        )
    if len(body) != body_bytes:
        raise WireError(
            f"truncated body: {len(body)} of {body_bytes} bytes"
        )
    got_sha = hashlib.sha256(body).hexdigest()
    if got_sha != want_sha:
        raise WireError(
            f"checksum mismatch (got {got_sha[:12]}…, "
            f"want {want_sha[:12]}…)"
        )
    itemsize = torch.empty((), dtype=dtype).element_size()
    per_side = layers * blocks * int(np.prod(page_shape)) * itemsize
    n_kv = page_shape[1]
    per_scale = layers * blocks * n_kv * 4 if scaled else 0
    if len(body) != 2 * per_side + 2 * per_scale:
        raise WireError(
            f"body is {len(body)} bytes, header shapes imply "
            f"{2 * per_side + 2 * per_scale}"
        )
    # one copy of the body, writable, that every returned tensor views
    buf = bytearray(body)

    def part(off: int, n: int, dt: torch.dtype, shape) -> torch.Tensor:
        if n == 0:
            return torch.empty(shape, dtype=dt)
        raw = torch.frombuffer(buf, dtype=torch.uint8, count=n, offset=off)
        return raw.view(dt).reshape(shape)

    shape = (layers, blocks) + page_shape
    pages_k = part(0, per_side, dtype, shape)
    pages_v = part(per_side, per_side, dtype, shape)
    scales_k = scales_v = None
    if scaled:
        sshape = (layers, blocks, n_kv)
        off = 2 * per_side
        scales_k = part(off, per_scale, torch.float32, sshape)
        scales_v = part(off + per_scale, per_scale, torch.float32, sshape)
    return KVBlockPayload(
        pages_k=pages_k, pages_v=pages_v,
        fingerprints=fingerprints, block_size=block_size,
        kv_dtype=kv_dtype, scales_k=scales_k, scales_v=scales_v,
        start_block=start_block,
    )
