"""Batched request->replica routing as a bucketed solver problem (PyTorch).

Counterpart of ``kubeinfer_tpu/solver/routing.py``. A whole arrival
batch becomes one requests x replicas problem built from the planes the
fleet advertises: the prefix match depth from the radix fingerprint
summaries, queue pressure and admission slots, KV headroom, and the hard
masks (dead / draining / breaker-open / excluded / padding) folded into a
-1 sentinel on the match plane. Both axes pad to the placement solver's
buckets (``problem.BUCKETS``), so padding rows and columns are never
chosen. Fingerprints are 63-bit FNV values, wider than a device int32,
so the match plane is built on the host in numpy int64 (copied from the
reference) and only the [B, R] i32 plane and the [R] vectors go to the
device.

Three solve modes:

- ``parity``: every row takes its independent masked argmax, the batched
  form of the router's per-request scan;
- ``greedy``: rounds with queue-pressure feedback; each accepted request
  raises its replica's pressure by 1/slots and a replica accepts at most
  its slot width per round, the lowest request indices first; rows left
  after ``max_rounds`` take their argmax at the final pressure;
- ``auction``: each round the best bidder per replica wins at a price
  raised by its bid (value gap to its second choice + eps), the lowest
  request index on equal bids; assignments are final; stragglers past
  ``max_rounds`` take their argmax at the final prices.

The per-round primitive, the masked row argmax of ``match + bias``, is
``kernels.route_pick``: the kernel of ``csrc/route_pick.cu`` for CUDA
tensors, ``kernels.route_pick_plain`` for CPU tensors. The device of the
``RouteProblem`` decides which, so ``solve_routes`` has no ``accel``
argument. The reference's ``lax.while_loop``s become Python loops with
one host sync per round (the loop condition).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from kubeinfer_tpu_torch.device import resolve_device
# FNV-1a over tokens, chained per block and masked to 63 bits: the one
# definition lives with the radix cache whose fingerprints replicas
# advertise, so the request side's chains equal theirs
from kubeinfer_tpu_torch.inference.kv_blocks import (
    _FP_MASK,
    _FP_PRIME,
    _FP_SEED,
)
from kubeinfer_tpu_torch.solver import kernels
from kubeinfer_tpu_torch.solver.kernels import ROUTE_NEG
from kubeinfer_tpu_torch.solver.problem import bucket_size

# Encode-time clips bounding the score range: pressure beyond 64 queues
# per slot reads as saturated; match depth beyond 4096 blocks clips equal.
PRESSURE_CLIP = 64.0
MATCH_CLIP = 4096

# Auction bid floor in blocks: a row with no second choice still raises
# its replica's price by eps.
_AUCTION_EPS = 0.0625



@dataclass
class RouteProblem:
    """One arrival batch's routing problem, on one device. ``match`` folds
    the hard masks: -1 = ineligible (request, replica) pair; >= 0 =
    eligible with that prefix match depth in blocks."""

    match: torch.Tensor  # i32[B, R]
    pressure: torch.Tensor  # f32[R] queue depth / slots, clipped
    stale: torch.Tensor  # bool[R] signal older than the stale limit
    slots: torch.Tensor  # f32[R] admission slot width (>= 1)
    headroom: torch.Tensor  # f32[R] free-KV fraction in [0, 1]
    req_valid: torch.Tensor  # bool[B] padding mask

    def to(self, device: str | torch.device) -> "RouteProblem":
        return RouteProblem(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


@dataclass
class RouteAssignment:
    """Route-solve output: per-request replica index (-1 = no eligible
    replica) plus diagnostics."""

    replica: torch.Tensor  # i32[B]
    score: torch.Tensor  # f32[B] base-plane score of the chosen replica
    rounds: torch.Tensor  # i32 0-d solve rounds

    def to(self, device: str | torch.device) -> "RouteAssignment":
        return RouteAssignment(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


def batched_prefix_fingerprints(
    token_batch: Sequence[Sequence[int]],
    block_size: int,
    max_depth: int,
) -> np.ndarray:
    """Fingerprint of every full-block prefix of every request:
    ``i64[B, depth_max]``, -1 past each request's full-block depth.
    FNV-1a's 63-bit fold ``(h ^ t) * PRIME mod 2**63`` equals numpy's
    wrapping uint64 multiply followed by the 63-bit mask, so the chain
    vectorises across the batch with one loop over token positions."""
    B = len(token_batch)
    if block_size <= 0:
        raise ValueError(f"block_size must be > 0, got {block_size}")
    lens = np.fromiter((len(t) for t in token_batch), np.int64, B) \
        if B else np.zeros(0, np.int64)
    depths = np.minimum(lens // block_size, max_depth)
    depth_max = int(depths.max()) if B else 0
    out = np.full((B, depth_max), -1, np.int64)
    if depth_max == 0:
        return out
    T = depth_max * block_size
    mask = np.uint64(_FP_MASK)
    prime = np.uint64(_FP_PRIME)
    # zero-pad past each request's tail: the depths a pad could reach are
    # masked to -1 below. Equal-length batches convert in one call.
    if lens.min() == lens.max() and int(lens[0]) >= T:
        toks = (
            np.asarray(token_batch, np.int64)[:, :T].astype(np.uint64)
            & mask
        )
    else:
        toks = np.zeros((B, T), np.uint64)
        for b, t in enumerate(token_batch):
            n = min(len(t), T)
            if n:
                toks[b, :n] = (
                    np.asarray(t[:n], np.int64).astype(np.uint64) & mask
                )
    h = np.full(B, _FP_SEED, np.uint64)
    for d in range(depth_max):
        base = d * block_size
        for j in range(block_size):
            h = ((h ^ toks[:, base + j]) * prime) & mask
        out[:, d] = h.astype(np.int64)
    out[np.arange(depth_max)[None, :] >= depths[:, None]] = -1
    return out


def build_match_plane(
    token_batch: Sequence[Sequence[int]],
    fp_sets: Sequence[set | frozenset],
    block_sizes: Sequence[int],
) -> np.ndarray:
    """Host-side i32[B, R] prefix match depth in blocks: per block size,
    one sorted union of the advertised fingerprints, one searchsorted of
    each request chain against it, and a depth sweep that keeps the
    deepest membership per replica."""
    B, R = len(token_batch), len(fp_sets)
    match = np.zeros((B, R), np.int32)
    if B == 0 or R == 0:
        return match
    by_bs: dict[int, list[int]] = {}
    for r, bs in enumerate(block_sizes):
        if bs and fp_sets[r]:
            by_bs.setdefault(int(bs), []).append(r)
    for bs, cols in by_bs.items():
        # -1 pads short chains; fingerprints are non-negative
        fps = batched_prefix_fingerprints(token_batch, bs, MATCH_CLIP)
        depth_max = fps.shape[1]
        if depth_max == 0:
            continue
        union = np.array(
            sorted(frozenset().union(*(fp_sets[r] for r in cols))),
            np.int64,
        )
        # membership bitmap with a trailing all-False row for "in no set"
        memb = np.zeros((len(union) + 1, len(cols)), bool)
        for k, r in enumerate(cols):
            memb[
                np.searchsorted(union, np.fromiter(
                    fp_sets[r], np.int64, len(fp_sets[r])
                )),
                k,
            ] = True
        pos = np.searchsorted(union, fps)
        ok = pos < len(union)
        ok &= np.where(
            ok, union[np.minimum(pos, len(union) - 1)] == fps, False
        )
        row = np.where(ok & (fps != -1), pos, len(union))
        depth = np.zeros((B, len(cols)), np.int32)
        # ascending-depth overwrite keeps the deepest hit
        for d in range(depth_max):
            depth = np.where(memb[row[:, d]], d + 1, depth)
        match[:, cols] = depth
    return match


def pack_route_arrays(
    match: np.ndarray,  # i32[B_true, R_true], -1 = ineligible
    pressure: np.ndarray,  # f32[R_true]
    stale: np.ndarray,  # bool[R_true]
    slots: np.ndarray,  # f32[R_true]
    headroom: np.ndarray,  # f32[R_true]
    device: str | torch.device | None = None,
) -> tuple[RouteProblem, int, int]:
    """Pad to bucket shapes and copy to the device (the CUDA card unless
    the caller names another). Padding rows and columns carry match=-1
    and req_valid=False. Returns ``(problem, B, R)``, the padded sizes."""
    dev = resolve_device(device)
    B_true, R_true = match.shape
    B = bucket_size(max(B_true, 1))
    R = bucket_size(max(R_true, 1))
    m = np.full((B, R), -1, np.int32)
    m[:B_true, :R_true] = np.minimum(match, MATCH_CLIP)
    pr = np.zeros(R, np.float32)
    pr[:R_true] = np.minimum(pressure, PRESSURE_CLIP)
    st = np.zeros(R, bool)
    st[:R_true] = stale
    sl = np.ones(R, np.float32)
    sl[:R_true] = np.maximum(slots, 1.0)
    hr = np.ones(R, np.float32)
    hr[:R_true] = np.clip(headroom, 0.0, 1.0)
    rv = np.zeros(B, bool)
    rv[:B_true] = True
    return (
        RouteProblem(
            *(torch.from_numpy(a).to(dev) for a in (m, pr, st, sl, hr, rv))
        ),
        B,
        R,
    )


def solve_routes(
    rp: RouteProblem,
    *,
    alpha: float = 4.0,
    stale_penalty: float = 8.0,
    gamma: float = 0.0,
    mode: str = "parity",
    max_rounds: int = 8,
) -> RouteAssignment:
    """Assign every request in the batch to a replica, on ``rp``'s device.

    ``score[b, r] = match[b, r] - alpha * pressure[r]
                    - stale_penalty * stale[r] - gamma * (1 - headroom[r])``

    With gamma=0 this is the router's per-request objective, in f32. Ties
    go to the lowest replica index (callers sort replicas by name). The
    defaults are the router's (``ALPHA_QUEUE_BLOCKS``,
    ``STALE_PENALTY_BLOCKS``). Launches of ``kernels.route_pick``: 1 in
    ``parity``, rounds + 1 in ``greedy``, 2 rounds + 1 in ``auction``."""
    if mode not in ("parity", "greedy", "auction"):
        raise ValueError(f"unknown route mode {mode!r}")
    B, R = rp.match.shape
    dev = rp.match.device
    f32 = torch.float32

    def c(x):
        return torch.tensor(x, dtype=f32, device=dev)

    pick = kernels.route_pick
    bias0 = (
        c(-alpha) * rp.pressure
        - torch.where(rp.stale, c(stale_penalty), c(0.0))
        - c(gamma) * (c(1.0) - rp.headroom)
    )
    has_cand = (rp.match >= 0).any(dim=1) & rp.req_valid

    if mode == "parity":
        v, i = pick(rp.match, bias0, has_cand)
        return RouteAssignment(
            i, v, torch.ones((), dtype=torch.int32, device=dev)
        )

    assigned = torch.full((B,), -1, dtype=torch.int32, device=dev)
    r_iota = torch.arange(R, dtype=torch.int32, device=dev)
    rounds = 0

    def pending() -> bool:
        return bool(((assigned < 0) & has_cand).any())  # host sync

    if mode == "greedy":
        inv_slots = c(1.0) / rp.slots
        load = torch.zeros(R, dtype=f32, device=dev)
        while rounds < max_rounds and pending():
            active = (assigned < 0) & has_cand
            _, i = pick(rp.match, bias0 - c(alpha) * load, active)
            onehot = active[:, None] & (i[:, None] == r_iota[None, :])
            # exclusive rank by request index among this round's bidders
            # for each replica (integer counts, exact in f32 below 2**24)
            rank = torch.cumsum(onehot.to(torch.int32), dim=0) - onehot.to(torch.int32)
            accept = onehot & (rank.to(f32) < rp.slots[None, :])
            assigned = torch.where(accept.any(dim=1), i, assigned)
            load = load + accept.sum(dim=0).to(f32) * inv_slots
            rounds += 1
        # rows stranded by max_rounds take their argmax at the final load
        active = (assigned < 0) & has_cand
        _, i = pick(rp.match, bias0 - c(alpha) * load, active)
    else:
        neg = c(ROUTE_NEG)
        b_iota = torch.arange(B, dtype=torch.int32, device=dev)
        price = torch.zeros(R, dtype=f32, device=dev)
        while rounds < max_rounds and pending():
            active = (assigned < 0) & has_cand
            bias = bias0 - price
            v1, i1 = pick(rp.match, bias, active)
            # second-best value: mask each row's first choice, re-pick
            v2, i2 = pick(
                torch.where(r_iota[None, :] == i1[:, None], -1, rp.match),
                bias, active,
            )
            v2 = torch.where(i2 >= 0, v2, v1)  # sole candidate: bid eps
            bid = v1 - v2 + c(_AUCTION_EPS)
            onehot = active[:, None] & (i1[:, None] == r_iota[None, :])
            bids = torch.where(onehot, bid[:, None], neg)
            wv = bids.amax(dim=0)
            # winner = highest bid, ties to the lowest request index
            wb = torch.where(
                bids == wv[None, :], b_iota[:, None], kernels._I32MAX
            ).amin(dim=0)
            win = onehot & (b_iota[:, None] == wb[None, :])
            assigned = torch.where(win.any(dim=1), i1, assigned)
            price = price + torch.where(wv > neg, wv, c(0.0))
            rounds += 1
        active = (assigned < 0) & has_cand
        _, i = pick(rp.match, bias0 - price, active)
    assigned = torch.where(active, i, assigned)
    return RouteAssignment(
        assigned,
        _gather_scores(rp, bias0, assigned),
        torch.tensor(rounds, dtype=torch.int32, device=dev),
    )


def _gather_scores(
    rp: RouteProblem, bias0: torch.Tensor, assigned: torch.Tensor
) -> torch.Tensor:
    """Base-plane score of each chosen replica (feedback and price terms
    left out: the objective the router documents)."""
    safe = assigned.clamp_min(0).long()
    m = rp.match.gather(1, safe[:, None])[:, 0]
    s = m.to(torch.float32) + bias0[safe]
    return torch.where(
        assigned >= 0, s,
        torch.tensor(ROUTE_NEG, dtype=torch.float32, device=s.device),
    )


def decode_routes(out: RouteAssignment, n_requests: int) -> np.ndarray:
    """Host readback of the assignment, clipped to the true batch: the
    one ``.cpu()`` of a route solve. Padding rows have no eligible
    replica, so the clip loses nothing."""
    rep = out.replica.cpu().numpy()
    return np.asarray(rep[:n_requests], np.int32)


def solved_affinity(
    job_model: np.ndarray,  # i32[B] model slots (0 = none)
    node_cached: np.ndarray,  # uint8[N, MAX_MODELS]
    node_pressure: np.ndarray,  # f32[N]
    node_slots: np.ndarray,  # f32[N]
    *,
    alpha: float,
    cutoff: float,
    max_rounds: int = 8,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Reconciler affinity bitmap from a greedy route solve: each job row
    is a pseudo-request whose match depth on a node caching its model is
    ``cutoff * alpha`` blocks, so the router's score goes negative
    exactly when pressure reaches the cutoff. A node keeps a model's
    affinity bit only where the solve assigned one of that model's
    pseudo-requests to it AND the model is cached there."""
    B = int(len(job_model))
    N = int(node_cached.shape[0])
    out = np.zeros_like(node_cached)
    if B == 0 or N == 0:
        return out
    jm = np.clip(np.asarray(job_model, np.int64), 0,
                 node_cached.shape[1] - 1)
    cached_for_job = node_cached[:, jm].T.astype(bool)  # [B, N]
    if not cached_for_job.any():
        return out  # no affinity signal anywhere: skip the solve
    mscale = max(int(round(cutoff * alpha)), 1)
    match = np.where(cached_for_job, mscale, 0).astype(np.int32)
    rp, _, _ = pack_route_arrays(
        match,
        np.asarray(node_pressure, np.float32),
        np.zeros(N, bool),
        np.asarray(node_slots, np.float32),
        np.ones(N, np.float32),
        device=device,
    )
    assigned = decode_routes(
        solve_routes(
            rp, alpha=float(alpha), stale_penalty=0.0, mode="greedy",
            max_rounds=max_rounds,
        ),
        B,
    )
    hit = (assigned >= 0) & cached_for_job[np.arange(B),
                                           np.clip(assigned, 0, N - 1)]
    out[assigned[hit], np.asarray(job_model)[hit]] = 1
    return out
