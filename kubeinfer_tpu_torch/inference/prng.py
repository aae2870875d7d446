"""Counter-based threefry2x32, bit-equal to ``jax.random``'s.

The serving path samples with JAX's threefry keys (``engine.py`` splits
a per-call key; the slot path folds position counters into per-slot key
data). A ``torch.Generator`` would give other tokens for the same seed,
so this module carries the parts of ``jax.random`` the serving path
uses, on any device:

- ``PRNGKey(seed)`` / ``key(seed, impl="threefry2x32")``, ``key_data``
  and ``wrap_key_data`` (key data is an int64 tensor ``[..., 2]`` of
  32-bit words: JAX's ``u32[..., 2]``; there are no typed keys here);
- ``split`` and ``fold_in``;
- ``random_bits``, ``uniform`` and ``gumbel`` (float32, JAX's "low"
  mode).

Layout follows ``jax_threefry_partitionable=True`` (JAX's default from
0.5 on): ``split`` and ``random_bits`` hash the 64-bit row-major iota
of the output shape, split into (hi, lo) counter words, and 32-bit bits
are ``out1 ^ out2``. ``fold_in`` hashes the counter pair (0, data) as
JAX's ``threefry_2x32`` does for a two-word count. All arithmetic is on
int64 tensors masked to 32 bits (torch has no full uint32 arithmetic).
"""

from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_ROT0 = (13, 15, 26, 6)
_ROT1 = (17, 29, 16, 24)
_PARITY = 0x1BD11BDA
# float32 constants of jax.random.uniform/gumbel
_F32_TINY = torch.finfo(torch.float32).tiny
_ONE_BITS = 0x3F800000  # 1.0f


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), elementwise over broadcast
    int64 tensors of 32-bit words; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT0 if i % 2 == 0 else _ROT1:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x1, x2


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s data: (seed >> 32, seed & 0xFFFFFFFF)
    of the seed as a 32-bit integer (JAX without x64)."""
    s = int(seed)
    if not -(1 << 31) <= s < (1 << 31):
        raise ValueError(f"seed {seed} does not fit a 32-bit integer")
    # filled on the device, not copied from the host (no host sync)
    k = torch.zeros(2, dtype=torch.int64, device=device)
    k[1] = s & _MASK
    return k


def key(seed: int, impl: str = "threefry2x32", device=None) -> torch.Tensor:
    """``jax.random.key(seed, impl="threefry2x32")``; its ``key_data`` is
    ``PRNGKey(seed)``."""
    if impl != "threefry2x32":
        raise ValueError(f"only threefry2x32 keys are implemented, not {impl!r}")
    return PRNGKey(seed, device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    return k


def wrap_key_data(data: torch.Tensor, impl: str = "threefry2x32") -> torch.Tensor:
    if impl != "threefry2x32":
        raise ValueError(f"only threefry2x32 keys are implemented, not {impl!r}")
    return data


def _iota_2x32(shape, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The row-major 64-bit iota of ``shape`` as (hi, lo) 32-bit words."""
    n = 1
    for d in shape:
        n *= int(d)
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return flat >> 32, flat & _MASK


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``[num, 2]`` key data."""
    hi, lo = _iota_2x32((num,), k.device)
    b1, b2 = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for key data ``[..., 2]`` and a
    matching integer ``data`` (scalar or ``[...]``: JAX's fold under
    vmap), data taken modulo 2**32 as JAX's uint32 cast does."""
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    o1, o2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack([o1, o2], dim=-1)


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """32-bit ``jax.random.bits(key, shape)`` as int64 words. ``k`` may
    carry leading batch axes ``[..., 2]`` (one key per row, as under
    vmap); the result is ``[..., *shape]``."""
    shape = tuple(int(d) for d in shape)
    hi, lo = _iota_2x32(shape, k.device)
    lead = k.shape[:-1]
    expand = (slice(None),) * len(lead) + (None,) * len(shape)
    b1, b2 = threefry2x32(k[..., 0][expand], k[..., 1][expand], hi, lo)
    return b1 ^ b2


def uniform(k: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 ``jax.random.uniform``: the top 23 bits as a mantissa of
    [1, 2), minus 1, scaled into [minval, maxval) and floored at minval."""
    bits = random_bits(k, shape)
    fbits = ((bits >> 9) | _ONE_BITS).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    # device fills, not host-to-device copies: no host sync
    lo = torch.full((), minval, dtype=torch.float32, device=k.device)
    hi = torch.full((), maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def gumbel(k: torch.Tensor, shape) -> torch.Tensor:
    """float32 ``jax.random.gumbel(key, shape)`` in its default "low"
    mode: ``-log(-log(uniform(key, shape, tiny, 1)))``."""
    u = uniform(k, shape, _F32_TINY, 1.0)
    return -torch.log(-torch.log(u))
