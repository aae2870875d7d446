"""Host-side paged-KV bookkeeping: block pool refcounts + radix prefix
cache over token ids.

Counterpart of ``kubeinfer_tpu/inference/kv_blocks.py``, pure Python
and the same decisions: every allocation, refcount and free happens on
the host between device steps; the device only scatters into blocks the
host already committed, through the i32 block tables this module hands
out.

Design source: vLLM's PagedAttention block manager (Kwon et al. 2023)
for the pool, SGLang's RadixAttention (Zheng et al. 2024) for the
longest-prefix trie.

Reference counting contract:
- Block 0 is the reserved NULL block: never allocated, never freed.
  Hosts pad dead table entries with it and retired slots' decode
  scatters land in it (nondeterministic junk, read by nobody).
- A slot admit holds one reference per block in its table (fresh blocks
  arrive from alloc() with refcount 1; reused prefix blocks get a bump
  from RadixCache.match). Retire drops them all.
- The trie holds its own reference per cached node's block, so prefix
  blocks survive slot retirement until LRU eviction needs the space.

Lock order (outermost first): ContinuousEngine._lock ->
RadixCache._lock -> BlockPool._lock. The trie calls into the pool under
its own lock; nothing here calls back out.

The int8 pool's ``quantize_blocks``/``dequantize_blocks`` (one f32 scale
per (block, kv head)) sit at the end of the module; they are the only
part that touches tensors.
"""

from __future__ import annotations

import threading
from typing import Iterable, Sequence

import torch

NULL_BLOCK = 0

# -- path fingerprints --------------------------------------------------
#
# The fleet router scores replicas by longest
# advertised prefix match without ever shipping token ids across the
# control plane: each trie node carries a rolling hash of the block-key
# path from the root, and RadixCache.summary() exports a capped set of
# those fingerprints. The request side recomputes the same chain over
# its own prompt (prefix_fingerprints) and the deepest fingerprint
# present in a replica's advertised set IS the match depth. Both sides
# must use the identical chain function, which is why it lives here and
# the route solve (solver/routing.py) imports it — two implementations
# would silently drift.
#
# The hash is FNV-1a folded per token and chained per block, masked to
# 63 bits so fingerprints survive JSON round-trips (store heartbeats)
# as plain positive ints. Collisions only misroute a request to a
# replica that turns out cold — a performance blip, never a
# correctness issue — so 63 bits is plenty. Deliberately NOT Python's
# hash(): that is salted per process and two replicas would never agree.

_FP_SEED = 0xCBF29CE484222325 & ((1 << 63) - 1)  # FNV-1a offset basis
_FP_PRIME = 0x100000001B3
_FP_MASK = (1 << 63) - 1

# Heartbeat payload cap: a trie can grow to thousands of nodes, and the
# summary rides inside every NodeState heartbeat (agent -> store write,
# typically 1/s per node). 512 fingerprints is ~10 KiB of JSON — small
# next to the rest of NodeState, yet deep enough to advertise hundreds
# of distinct prefix families. Truncation keeps the LRU-newest (hottest)
# paths, so what gets dropped is exactly what the cache would evict
# first anyway; a truncated summary only understates match depth.
SUMMARY_FINGERPRINT_BUDGET = 512


def extend_fingerprint(fp: int, key: Sequence[int]) -> int:
    """Chain one block of token ids onto a path fingerprint."""
    h = fp
    for t in key:
        h = ((h ^ (int(t) & _FP_MASK)) * _FP_PRIME) & _FP_MASK
    return h


def prefix_fingerprints(tokens: Sequence[int], block_size: int) -> list[int]:
    """Fingerprint of every full-block prefix of ``tokens``,
    shallowest first — element i covers tokens[0 : (i+1)*block_size].
    The partial tail block is never fingerprinted, mirroring the trie's
    full-blocks-only keying (the tail is copy-on-write, never shared)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be > 0, got {block_size}")
    out: list[int] = []
    fp = _FP_SEED
    for i in range(0, len(tokens) - block_size + 1, block_size):
        fp = extend_fingerprint(fp, tokens[i:i + block_size])
        out.append(fp)
    return out


class BlockPool:
    """Fixed-size pool of KV blocks with host-side refcounts.

    Pure bookkeeping — the actual [num_blocks, block_size, n_kv, D]
    device tensors live in the engine's SlotState; indices handed out
    here are what the block tables (and the Pallas index_map) resolve.
    Indices are logical per the module's device-layout audit: one pool,
    whatever the tensor's sharding.
    """

    def __init__(self, num_blocks: int, block_size: int) -> None:
        if num_blocks < 2:
            raise ValueError(
                f"BlockPool needs >= 2 blocks (one is the reserved null "
                f"block); got {num_blocks}"
            )
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are re-issued first,
        # which keeps the working set of physical blocks small (warmer
        # in whatever cache hierarchy the backend has).
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = [0] * self.num_blocks

    def alloc(self, n: int) -> list[int]:
        """Take n blocks at refcount 1. Raises when the pool cannot
        supply them — callers gate on free_blocks (or
        RadixCache.ensure_free) first, so hitting this is a logic bug,
        not backpressure."""
        with self._lock:
            if n > len(self._free):
                raise RuntimeError(
                    f"BlockPool exhausted: need {n}, have "
                    f"{len(self._free)} free of {self.num_blocks}"
                )
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
            return out

    def ref(self, blocks: Iterable[int]) -> None:
        with self._lock:
            for b in blocks:
                if self._ref[b] <= 0:
                    raise RuntimeError(f"ref of free block {b}")
                self._ref[b] += 1

    def unref(self, blocks: Iterable[int]) -> int:
        """Drop one reference per block; blocks reaching 0 return to
        the free list. Returns how many were freed."""
        freed = 0
        with self._lock:
            for b in blocks:
                if b == NULL_BLOCK:
                    raise RuntimeError("unref of the null block")
                if self._ref[b] <= 0:
                    raise RuntimeError(f"unref of free block {b}")
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    self._free.append(b)
                    freed += 1
        return freed

    def refcount(self, block: int) -> int:
        with self._lock:
            return self._ref[block]

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self) -> int:
        # excludes the null block: it is neither free nor usable
        with self._lock:
            return self.num_blocks - 1 - len(self._free)


class _Node:
    """One trie edge = one full block of tokens. The node holds the
    pool block storing that span's KV (trie's own +1 reference)."""

    __slots__ = ("children", "parent", "key", "block", "stamp", "fp")

    def __init__(self, parent: "_Node | None", key: tuple | None,
                 block: int) -> None:
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.stamp = 0
        # path fingerprint root->here, extended incrementally so insert
        # stays O(block_size) per new node instead of re-hashing the
        # whole path
        self.fp = (
            _FP_SEED if parent is None
            else extend_fingerprint(parent.fp, key)
        )


class RadixCache:
    """Longest-prefix KV reuse over full blocks.

    Keys are ``block_size``-token tuples, so a lookup walks at most
    len(prompt) // block_size edges and the matched depth is always a
    whole number of blocks — the partial tail block is never shared
    (copy-on-write by construction: the admit path recomputes the tail
    into a fresh block instead of appending to a shared one).

    Eviction is LRU over leaves whose block nobody else references
    (pool refcount == 1, i.e. only the trie's own hold) — an interior
    node can only be evicted after its children, which preserves the
    invariant that every cached path is fully materialized.
    """

    def __init__(self, pool: BlockPool) -> None:
        self._pool = pool
        self._lock = threading.Lock()
        self._root = _Node(None, None, NULL_BLOCK)
        self._clock = 0  # monotonic LRU stamp; touched on every match
        self._nodes = 0
        # summary version: bumps whenever the advertised fingerprint set
        # can have changed (insert created nodes / eviction removed one)
        # so routers can diff summaries by a single int compare
        self._version = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _keys(self, tokens: Sequence[int]) -> list[tuple]:
        bs = self._pool.block_size
        return [
            tuple(tokens[i: i + bs])
            for i in range(0, len(tokens) - bs + 1, bs)
        ]

    def match(self, tokens: Sequence[int]) -> list[int]:
        """Longest-prefix match in full blocks. Returns the matched
        block ids in sequence order, each with one reference taken for
        the caller (so eviction cannot free them between this call and
        the admit that consumes them). The caller must unref any it
        decides not to use."""
        with self._lock:
            self._clock += 1
            out: list[int] = []
            node = self._root
            for key in self._keys(tokens):
                child = node.children.get(key)
                if child is None:
                    break
                child.stamp = self._clock
                out.append(child.block)
                node = child
            self._pool.ref(out)
            return out

    def match_with_fingerprints(
        self, tokens: Sequence[int],
    ) -> list[tuple[int, int]]:
        """``match()`` plus each matched node's path fingerprint:
        ``[(block, fp), ...]`` shallowest first, where ``fp`` covers
        tokens[0 : (i+1)*block_size] — the exact chain
        ``prefix_fingerprints`` would recompute. The KV export side
        content-addresses blocks with these (disagg/export.py) without
        re-hashing the prompt. Same reference contract as ``match()``:
        one caller-owned reference per returned block, unref what you
        don't consume."""
        with self._lock:
            self._clock += 1
            out: list[tuple[int, int]] = []
            node = self._root
            for key in self._keys(tokens):
                child = node.children.get(key)
                if child is None:
                    break
                child.stamp = self._clock
                out.append((child.block, child.fp))
                node = child
            self._pool.ref([b for b, _ in out])
            return out

    def insert(self, tokens: Sequence[int], blocks: Sequence[int]) -> int:
        """Cache the full blocks of ``tokens``: blocks[i] holds tokens
        [i*bs, (i+1)*bs). Existing nodes keep their block (the caller's
        table already names them — match() handed them out); each NEW
        node takes the trie's own reference on the caller's block.
        Returns how many new nodes were created."""
        created = 0
        with self._lock:
            self._clock += 1
            node = self._root
            for key, block in zip(self._keys(tokens), blocks):
                child = node.children.get(key)
                if child is None:
                    child = _Node(node, key, block)
                    node.children[key] = child
                    self._pool.ref([block])
                    self._nodes += 1
                    created += 1
                child.stamp = self._clock
                node = child
            if created:
                self._version += 1
        return created

    def note_result(self, reused_blocks: int) -> None:
        """Record one admit's outcome for the hit/miss counters: a hit
        is an admit that actually reused >= 1 block (after the engine's
        capacity clamp), not merely one that matched."""
        with self._lock:
            if reused_blocks > 0:
                self.hits += 1
            else:
                self.misses += 1

    def _evict_one(self) -> bool:
        # LRU scan over evictable leaves. O(nodes), fine at serving
        # scale (thousands of nodes); called only when the pool is
        # actually short.
        victim: _Node | None = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if (
                node is not self._root
                and not node.children
                and self._pool.refcount(node.block) == 1
                and (victim is None or node.stamp < victim.stamp)
            ):
                victim = node
        if victim is None:
            return False
        assert victim.parent is not None
        del victim.parent.children[victim.key]
        self._pool.unref([victim.block])
        self._nodes -= 1
        self.evictions += 1
        self._version += 1
        return True

    def evictable_blocks(self) -> int:
        """Upper bound on blocks eviction could reclaim right now:
        trie nodes whose block only the trie holds (pool refcount 1).
        It is an overestimate when a refcount-1 interior node sits above
        a pinned child (that subtree path cannot be fully torn down),
        but an overestimate only delays the fail-fast below to the first
        stuck ``_evict_one`` — it never rejects a servable request."""
        with self._lock:
            return self._evictable_locked()

    def _evictable_locked(self) -> int:
        count = 0
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is not self._root and self._pool.refcount(node.block) == 1:
                count += 1
        return count

    def ensure_free(self, n: int) -> bool:
        """Evict LRU-first until the pool has n free blocks. False when
        eviction cannot get there (everything live is pinned by slots or
        parked rows) — the engine treats that as admission backpressure.

        Fails fast BEFORE evicting anything when free + evictable can
        never reach n: under preemption pressure a hopeless request used
        to strip the entire reusable cache on its way to False, turning
        one backpressured admit into a cold-start penalty for every
        later warm admit. The loop itself always terminates — each
        successful ``_evict_one`` frees exactly one block."""
        with self._lock:
            if n > self._pool.free_blocks + self._evictable_locked():
                return False
            while self._pool.free_blocks < n:
                if not self._evict_one():
                    return False
            return True

    def stats(self) -> dict:
        """Counters plus trie shape. ``nodes``/``leaves`` and
        ``cached_tokens`` (= nodes x block_size, every edge is exactly
        one full block) are the capacity denominators a summary
        consumer needs to judge how much of the trie its capped
        fingerprint set actually covers."""
        with self._lock:
            leaves = 0
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                if node.children:
                    stack.extend(node.children.values())
                else:
                    leaves += 1
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "nodes": self._nodes,
                "leaves": leaves,
                "cached_tokens": self._nodes * self._pool.block_size,
            }

    def summary(self, budget: int = SUMMARY_FINGERPRINT_BUDGET) -> dict:
        """Compact advertisement of what this cache holds, for the
        fleet router: every cached path's fingerprint (hottest first,
        capped at ``budget``), the block size the request side must use
        to recompute matching fingerprints, and a version that bumps on
        any insert/evict so consumers can skip unchanged summaries.

        Truncation order is deterministic: LRU stamp descending (the
        paths the cache would keep longest advertise first), fingerprint
        as the tie-break so equal-stamp nodes — e.g. a whole path
        inserted by one admit — never reorder between two exports of
        the same trie. ``total_nodes`` lets a consumer see HOW MUCH was
        dropped, not just whether (``truncated``)."""
        with self._lock:
            entries: list[tuple[int, int]] = []
            stack = list(self._root.children.values())
            while stack:
                node = stack.pop()
                stack.extend(node.children.values())
                entries.append((node.stamp, node.fp))
            entries.sort(key=lambda e: (-e[0], e[1]))
            return {
                "version": self._version,
                "block_size": self._pool.block_size,
                "total_nodes": len(entries),
                "truncated": len(entries) > budget,
                "fingerprints": [fp for _, fp in entries[:budget]],
            }


# -- int8 block quantization --------------------------------------------
#
# The kv_dtype="int8" pool stores committed blocks as int8 values plus ONE
# f32 scale per (block, kv head): symmetric absmax over the block's
# (block_size, head_dim) span, scale = absmax / 127. The arithmetic is the
# reference's op for op: the codes multiply by the reciprocal of the
# scale (not a division), round half to even (torch.round, as jnp.round),
# and dequantization is int8 -> f32, times the scale, then the cast.


def device_scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``like``'s device: PyTorch's CUDA
    division by a Python (CPU) scalar multiplies by its reciprocal, which
    is not the reference's amax / 127 (it can differ in the last bit)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., block_size, n_kv, D] float pages -> (int8 pages, f32[...,
    n_kv] scales). An all-zero block (the null block, unwritten pool
    space) gets scale 1.0, so it dequantizes to exactly 0."""
    xf = x.float()
    amax = xf.abs().amax(dim=(-3, -1))  # [..., n_kv]
    scale = torch.where(amax > 0, amax / device_scalar(amax, 127.0),
                        torch.ones_like(amax))
    inv = 1.0 / scale[..., None, :, None]
    q = torch.clamp(torch.round(xf * inv), -127.0, 127.0).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """Inverse of :func:`quantize_blocks`: int8 pages [..., bs, n_kv, D]
    times f32 scales [..., n_kv] -> float pages (``dtype`` or f32)."""
    out = q.float() * scale[..., None, :, None]
    return out if dtype is None else out.to(dtype)
