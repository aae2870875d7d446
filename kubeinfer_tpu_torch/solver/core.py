"""The ``jax-greedy`` and ``jax-auction`` placement solves in PyTorch.

Counterpart of ``kubeinfer_tpu/solver/core.py``. The greedy solve: the
resident node-major [N, J] cost field S (static cost + integer-hash tie
noise + rank-1 fit term), the dense priority rank and its four-class
fence, the packed accept key, incumbent seeding, one of the two main
loops, the preemption repair, the gang repair and the fill. The main
loop is, as the reference routes it on its accelerator
(``resolve_accel``):

- ``"mega"``, the class-serialised loop (``kernels.mega_solve``, one
  launch for every round), when both axes are 128-aligned and a mega
  window fits;
- ``"pallas"``, the pipelined round loop (``run_rounds``: fence, bid and
  two accept passes per round, ``kernels.fence``/``bid``/``accept``),
  otherwise — small clusters, clusters too wide for a window, and any
  solve that asks for it.

The reference's ``lax.while_loop``/``lax.cond`` become Python control
flow; each branch on a device value is a host sync:

- the sortedness check that picks the dense-rank algorithm;
- on the pipelined loop, one per round (its loop condition) and one when
  it starts;
- per preemption-repair iteration (seeded solves with a squatting seat):
  its loop condition and whether any node is reclaimable;
- whether the gang repair + fill runs, and on the pipelined loop the
  fill's round cap.

The mega loop itself runs on the device with no host sync. Where the
reference avoided a gather or a scatter for the TPU's sake (the one-hot
matmul for cache hits, the one-hot sandwich of the gang repair), the port
uses PyTorch's own form, whose result is identical.

The auction solve (``solve_auction``): a job-major [J, N] benefit field,
the Jacobi auction loop (``kernels.auction_solve``, one launch for every
iteration, with no host sync inside), then the gang repair and, when a
valid job is left unplaced, a greedy fill through ``solve_greedy``. Its
host syncs: whether the fill runs, and the fill's own.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, NamedTuple

import torch

from kubeinfer_tpu_torch.device import resolve_device
from kubeinfer_tpu_torch.solver import kernels
from kubeinfer_tpu_torch.solver.kernels import INFEASIBLE, RANK_INF, mega_window
from kubeinfer_tpu_torch.solver.problem import Problem

_EPS = 1e-4  # capacity comparison slack for f32 fractional demands
# Floor on the tie-spreading scale: perfectly tied jobs must not all bid
# one node per round even at weights.noise=0.
_MIN_TIE_NOISE = 1e-3
_I32MAX = 0x7FFFFFFF
_FENCE_CLASSES = 4


@dataclass(frozen=True)
class ScoreWeights:
    """Cost-field weights (lower cost = better placement); the same fields
    and defaults as the reference's ``ScoreWeights``: best-fit pressure,
    cache-hit discount, move hysteresis, topology miss, tie noise."""

    fit_gpu: float = 1.0
    fit_mem: float = 0.5
    cache: float = 5.0
    move: float = 8.0
    topology: float = 2.0
    noise: float = 0.3


@dataclass
class Assignment:
    """Solver output: per-job node index (-1 = unplaced) + diagnostics."""

    node: torch.Tensor  # i32[J]
    gpu_free: torch.Tensor  # f32[N] capacity remaining after placement
    mem_free: torch.Tensor  # f32[N]
    rounds: torch.Tensor  # i32 0-d, settlement rounds, summed over mega
    # windows or pipelined-loop invocations
    placed: torch.Tensor  # i32 0-d, placed valid jobs


def _static_cost_t(p: Problem, w: ScoreWeights) -> torch.Tensor:
    """[N, J] cost terms that don't depend on remaining capacity. The cache
    hit is a gather (``cached[:, model_id]``) where the reference used a
    one-hot matmul; both select exactly one bit per (node, job)."""
    jobs, nodes = p.jobs, p.nodes
    N = nodes.valid.shape[0]
    hit = nodes.cached[:, jobs.model_id.long()]  # [N, J] bool
    cost = w.cache * (1.0 - hit.to(torch.float32))
    n_idx = torch.arange(N, dtype=torch.int32, device=p.device)
    has_home = jobs.current_node >= 0
    moved = has_home[None, :] & (jobs.current_node[None, :] != n_idx[:, None])
    cost = cost + w.move * moved.to(torch.float32)
    home = jobs.current_node.clamp(0, N - 1).long()
    pref = torch.where(has_home, nodes.topology[home], -1)
    topo_miss = (pref[None, :] >= 0) & (pref[None, :] != nodes.topology[:, None])
    return cost + w.topology * topo_miss.to(torch.float32)


def _inv_capacity(nodes) -> tuple[torch.Tensor, torch.Tensor]:
    """f32[N] 1 / capacity normalizers of the fit terms (capacity floored
    at 1)."""
    return (
        torch.ones_like(nodes.gpu_capacity) / nodes.gpu_capacity.clamp_min(1.0),
        torch.ones_like(nodes.mem_capacity) / nodes.mem_capacity.clamp_min(1.0),
    )


def _fit_cost(p: Problem, w: ScoreWeights) -> torch.Tensor:
    """[J, N] best-fit pressure: normalized leftover capacity as cost
    (the reference's ``_fit_cost`` scored against the free capacity)."""
    jobs, nodes = p.jobs, p.nodes
    inv_gpu_cap, inv_mem_cap = _inv_capacity(nodes)
    cost = w.fit_gpu * (
        (nodes.gpu_free[None, :] - jobs.gpu_demand[:, None])
        * inv_gpu_cap[None, :]
    )
    return cost + w.fit_mem * (
        (nodes.mem_free[None, :] - jobs.mem_demand[:, None])
        * inv_mem_cap[None, :]
    )


def _prank_sorted(neg_p: torch.Tensor) -> torch.Tensor:
    """Dense rank of a NON-DECREASING key vector: cumsum over new-distinct
    markers. Only valid on sorted input (checked by the caller)."""
    first = torch.ones_like(neg_p, dtype=torch.bool)
    first[1:] = neg_p[1:] != neg_p[:-1]
    return (torch.cumsum(first.to(torch.int32), 0) - 1).to(torch.int32)


def _prank_dense(neg_p: torch.Tensor) -> torch.Tensor:
    """Dense rank for arbitrary order by comparison counting: the number
    of DISTINCT smaller values (first occurrences that are smaller)."""
    J = neg_p.shape[0]
    j_iota = torch.arange(J, device=neg_p.device)
    first_occ = ~(
        (neg_p[None, :] == neg_p[:, None]) & (j_iota[None, :] < j_iota[:, None])
    ).any(dim=1)
    return (
        ((neg_p[None, :] < neg_p[:, None]) & first_occ[None, :])
        .sum(dim=1)
        .to(torch.int32)
    )


def tie_noise_hash(N: int, J: int, device: torch.device) -> torch.Tensor:
    """The reference's fmix-style int32 hash over (node, job), in PyTorch's
    wrapping int32 arithmetic (arithmetic >>): bit-identical to it."""
    n = torch.arange(N, dtype=torch.int32, device=device)[:, None]
    j = torch.arange(J, dtype=torch.int32, device=device)[None, :]
    h = n * -1640531527 + j * 40503
    h = h ^ (h >> 13)
    h = h * -1274126529
    return h ^ (h >> 16)


def auction_tiebreak(J: int, N: int, device: torch.device) -> torch.Tensor:
    """The auction's per-(job, node) i31 selection tie-break: the tie-noise
    hash with the axes swapped, masked to 31 bits (the reference's
    ``_auction_tiebreak``)."""
    return tie_noise_hash(J, N, device) & _I32MAX


def quant_constants(N: int, weights: ScoreWeights) -> tuple[int, float, float, float]:
    """Static quantization bounds and i31 packing: ``(node_idx_bits, q_lo,
    q_scale, q_max)``. The tie noise is uniform in [-2, 6) x scale, so the
    bounds are exact, not tail estimates."""
    node_idx_bits = max((N - 1).bit_length(), 1)
    cost_bits = 31 - node_idx_bits
    fit_sum = weights.fit_gpu + weights.fit_mem
    noise_scale = max(weights.noise, _MIN_TIE_NOISE)
    q_lo = -fit_sum - 2.0 * noise_scale
    q_hi = (
        weights.cache + weights.move + weights.topology
        + fit_sum + 6.0 * noise_scale
    )
    q_max = float((1 << cost_bits) - 2)
    return node_idx_bits, q_lo, q_max / (q_hi - q_lo), q_max


def accept_key(prank: torch.Tensor, gpu_demand: torch.Tensor) -> torch.Tensor:
    """Per-job accept key: priority rank, then demand DESCENDING (first-fit
    decreasing), then job index — single-valued per job."""
    J = prank.shape[0]
    j_idx_bits = max((J - 1).bit_length(), 1)
    rank_bits = 31 - j_idx_bits - 4
    rank_c = prank.clamp(0, (1 << rank_bits) - 1)
    dmax = gpu_demand.max().clamp_min(1.0)
    demand_q = (
        (gpu_demand * (torch.full_like(dmax, 15.0) / dmax))
        .clamp(0, 15)
        .to(torch.int32)
    )
    return (
        (rank_c << (4 + j_idx_bits))
        | ((15 - demand_q) << j_idx_bits)
        | torch.arange(J, dtype=torch.int32, device=prank.device)
    )


def _gang_repair(p: Problem, assigned: torch.Tensor):
    """Unwind incompletely placed gangs (all-or-nothing) and recompute
    capacity from scratch. Returns ``(assigned, gpu_free, mem_free)``.
    Member and placed counts per gang are ``bincount``s and the capacity
    sums ``index_add_``s; the reference's one-hot matmul sandwich computes
    the same integer counts (gang ids are dense in [0, J))."""
    jobs, nodes = p.jobs, p.nodes
    J = jobs.valid.shape[0]
    in_gang = (jobs.gang_id >= 0) & jobs.valid
    gid = torch.where(in_gang, jobs.gang_id, 0).long()
    need = torch.bincount(gid[in_gang], minlength=J)
    got = torch.bincount(gid[in_gang & (assigned >= 0)], minlength=J)
    keep = ~in_gang | (got[gid] == need[gid])
    assigned = torch.where(keep, assigned, -1)
    used_g, used_m = _node_sums(assigned, jobs.gpu_demand, jobs.mem_demand, nodes)
    return assigned, nodes.gpu_free - used_g, nodes.mem_free - used_m


def _node_sums(node_of, gpu, mem, nodes):
    """Per-node demand sums of the jobs with ``0 <= node_of < N`` (an
    out-of-range incumbent matches no node, as in the reference's
    broadcast-compare). Exact in any order for the small dyadic demands the
    solver is built on."""
    N = nodes.valid.shape[0]
    on = (node_of >= 0) & (node_of < N)
    idx = node_of[on].long()
    used_g = torch.zeros(N, dtype=torch.float32, device=gpu.device)
    used_m = torch.zeros_like(used_g)
    used_g.index_add_(0, idx, gpu[on])
    used_m.index_add_(0, idx, mem[on])
    return used_g, used_m


@dataclass
class CostField:
    """What the mega loop reads, fixed for one solve: the resident cost
    field S, the accept key, the fence rank, the fit-pressure weights and
    the static quantization constants."""

    S: torch.Tensor  # f32[N, J] node-major
    key: torch.Tensor  # i32[J]
    rankf: torch.Tensor  # f32[J] class-compressed fence rank
    v_g: torch.Tensor  # f32[N]
    v_m: torch.Tensor  # f32[N]
    node_idx_bits: int
    q_lo: float
    q_scale: float
    q_max: float

    def run(self, fn, jobs, asg, rank, may, gf_eff, mf, max_rounds):
        """Call ``fn`` (``kernels.mega_solve`` or ``kernels.mega_rounds``)
        on this field from the given assignment and capacities."""
        return fn(
            self.S, jobs.gpu_demand, jobs.mem_demand, self.key, rank,
            jobs.current_node, asg, may, gf_eff, mf, self.v_g, self.v_m,
            max_rounds=max_rounds, q_lo=self.q_lo, q_scale=self.q_scale,
            q_max=self.q_max, node_idx_bits=self.node_idx_bits,
        )


class RoundOps(NamedTuple):
    """The three round ops ``run_rounds`` calls, with the signatures of
    ``kernels.fence``, ``kernels.bid`` and ``kernels.accept`` (the
    default; ``run_rounds`` passes accept the solve's
    ``kernels.AcceptWorkspace`` last); a caller may pass others, e.g. ones
    that also check each kernel against its plain version."""

    fence: Callable
    bid: Callable
    accept: Callable


def run_rounds(
    f: CostField,
    jobs,
    assigned: torch.Tensor,
    gpu_free: torch.Tensor,
    mem_free: torch.Tensor,
    rounds0: int,
    rankf_base: torch.Tensor,
    round_cap: int,
    ops: RoundOps | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The pipelined greedy loop (kubeinfer_tpu/solver/core.py:693-799):
    rounds to a fixpoint from the given state, counting on from
    ``rounds0`` up to the absolute ``round_cap``. Jobs whose
    ``rankf_base`` is RANK_INF never bid (the fill fences unwound gang
    members this way). ``gpu_free`` arrives with invalid nodes folded to
    -1. Returns ``(assigned, gpu_free, mem_free, rounds)``.

    A round: fence minimum, bids, a first accept pass on the primary
    bids, then a second-chance pass in which the first pass's losers bid
    their alternate node against the updated capacities — except
    incumbents whose primary was their home. The loop condition is one
    host sync per round."""
    ops = ops or RoundOps(kernels.fence, kernels.bid, kernels.accept)
    N = gpu_free.shape[0]
    # the accept kernel's accumulators, one for every accept call of the
    # solve: each call leaves the next one's half zeroed
    ws = kernels.AcceptWorkspace(N, gpu_free.device)
    d, md, cur = jobs.gpu_demand, jobs.mem_demand, jobs.current_node
    node_mask = (1 << f.node_idx_bits) - 1
    rounds = rounds0
    progress = bool(((assigned < 0) & jobs.valid).any())  # host sync
    while progress and rounds < round_cap:
        rankf_eff = torch.where(assigned < 0, rankf_base, RANK_INF)
        u = f.v_g * gpu_free + f.v_m * mem_free
        minrank = ops.fence(gpu_free, mem_free, d, md, rankf_eff)
        prim, alt = ops.bid(
            f.S, u, gpu_free, mem_free, d, md, rankf_eff, minrank, cur,
            q_lo=f.q_lo, q_scale=f.q_scale, q_max=f.q_max,
            node_idx_bits=f.node_idx_bits,
        )
        has1 = prim != _I32MAX
        choice1 = torch.where(has1, prim & node_mask, N)
        accept1, used_g, used_m = ops.accept(
            choice1, f.key, d, md, gpu_free, mem_free, ws
        )
        assigned = torch.where(accept1, choice1, assigned)
        gpu_free = gpu_free - used_g
        mem_free = mem_free - used_m
        home_bid = (cur >= 0) & (choice1 == cur)
        retry = has1 & ~accept1 & (alt != _I32MAX) & ~home_bid
        choice2 = torch.where(retry, alt & node_mask, N)
        accept2, used_g, used_m = ops.accept(
            choice2, f.key, d, md, gpu_free, mem_free, ws
        )
        assigned = torch.where(accept2, choice2, assigned)
        gpu_free = gpu_free - used_g
        mem_free = mem_free - used_m
        rounds += 1
        # any bid implies an accept (a contested node's winner fits the
        # capacities it bid against), so no accept means a fixpoint
        progress = bool(  # host sync
            (accept1.any() | accept2.any())
            & ((assigned < 0) & jobs.valid).any()
        )
    return assigned, gpu_free, mem_free, rounds


ACCELS = ("auto", "mega", "pallas")


def resolve_accel(accel: str, J: int, N: int) -> str:
    """The main loop for a (J, N) bucket, as the reference routes it on its
    accelerator (kubeinfer_tpu/solver/core.py:437-461): ``"auto"`` is
    ``"mega"`` iff both axes are 128-aligned and a mega window fits, else
    ``"pallas"`` (the pipelined loop). Whether the kernels or their plain
    versions run is decided by the tensors' device, not here."""
    if accel not in ACCELS:
        raise ValueError(f"unknown accel {accel!r}; want one of {ACCELS}")
    if accel != "auto":
        return accel
    if J % 128 == 0 and N % 128 == 0 and mega_window(N, J) is not None:
        return "mega"
    return "pallas"


def cost_field(p: Problem, weights: ScoreWeights) -> CostField:
    """Build the round-invariant state of a solve
    (kubeinfer_tpu/solver/core.py:498-629): dense priority rank and
    four-class fence rank, tie noise, S, quantization constants and
    accept key."""
    jobs, nodes = p.jobs, p.nodes
    J = jobs.valid.shape[0]
    N = nodes.valid.shape[0]
    static_cost = _static_cost_t(p, weights)
    inv_gpu_cap, inv_mem_cap = _inv_capacity(nodes)

    neg_p = torch.where(jobs.valid, -jobs.priority, float("inf"))
    if bool((neg_p[1:] >= neg_p[:-1]).all()):  # host sync
        prank = _prank_sorted(neg_p)
    else:
        prank = _prank_dense(neg_p)
    n_classes = torch.where(jobs.valid, prank, -1).max() + 1
    crank = torch.div(
        prank * _FENCE_CLASSES, n_classes.clamp_min(1), rounding_mode="floor"
    )
    crank = crank.clamp_max(_FENCE_CLASSES - 1)
    rankf = torch.where(jobs.valid, crank.to(torch.float32), RANK_INF)

    h = tie_noise_hash(N, J, p.device)
    base_noise = max(weights.noise, _MIN_TIE_NOISE) * (
        (h & 0x7FFFFF).to(torch.float32) * (8.0 / float(1 << 23)) - 2.0
    )
    del h
    # the best-fit term w*(free[n]-d[j])/cap[n] splits into a per-round [N]
    # vector (from live capacity) and this round-invariant rank-1 product
    v_g = weights.fit_gpu * inv_gpu_cap
    v_m = weights.fit_mem * inv_mem_cap
    S = (
        static_cost
        + base_noise
        - v_g[:, None] * jobs.gpu_demand[None, :]
        - v_m[:, None] * jobs.mem_demand[None, :]
    )
    node_idx_bits, q_lo, q_scale, q_max = quant_constants(N, weights)
    return CostField(
        S, accept_key(prank, jobs.gpu_demand), rankf, v_g, v_m,
        node_idx_bits, q_lo, q_scale, q_max,
    )


def seed_incumbents(p: Problem, seeded: bool):
    """Incumbent seeding (kubeinfer_tpu/solver/core.py:814-857): every
    incumbent whose node still jointly fits all of its incumbents holds
    its seat up front. Returns ``(asg_init, gf_seed, mf_seed, seated)``;
    gf_seed has invalid nodes folded to -1."""
    jobs, nodes = p.jobs, p.nodes
    J = jobs.valid.shape[0]
    N = nodes.valid.shape[0]
    gf_valid = torch.where(nodes.valid, nodes.gpu_free, -1.0)
    if not seeded:
        none = torch.zeros(J, dtype=torch.bool, device=p.device)
        return (
            torch.full((J,), -1, dtype=torch.int32, device=p.device),
            gf_valid, nodes.mem_free, none,
        )
    at_home = (jobs.current_node >= 0) & jobs.valid
    used_g, used_m = _node_sums(
        torch.where(at_home, jobs.current_node, -1),
        jobs.gpu_demand, jobs.mem_demand, nodes,
    )
    ok_node = (used_g <= gf_valid + _EPS) & (used_m <= nodes.mem_free + _EPS)
    seated = at_home & ok_node[jobs.current_node.clamp(0, N - 1).long()]
    return (
        torch.where(seated, jobs.current_node, -1),
        gf_valid - torch.where(ok_node, used_g, 0.0),
        nodes.mem_free - torch.where(ok_node, used_m, 0.0),
        seated,
    )


def solve_greedy(
    p: Problem,
    weights: ScoreWeights = ScoreWeights(),
    max_rounds: int = 64,
    seeded: bool = True,
    device: str | torch.device | None = None,
    accel: str = "auto",
) -> Assignment:
    """Parallel greedy with conflict resolution (policy ``jax-greedy``).
    ``accel`` picks the main loop (``resolve_accel``): on ``"mega"`` every
    settlement round of every priority window runs in
    ``kernels.mega_solve`` and ``max_rounds`` is a per-window budget; on
    ``"pallas"`` the rounds run in ``run_rounds`` and ``max_rounds`` bounds
    each invocation. ``seeded`` turns on incumbent seeding and the
    preemption repair; it is inert without incumbents."""
    dev = resolve_device(device)
    p = p.to(dev)
    jobs, nodes = p.jobs, p.nodes
    J = jobs.valid.shape[0]
    N = nodes.valid.shape[0]
    accel = resolve_accel(accel, J, N)
    W = mega_window(N, J)
    if accel == "mega" and W is None:
        raise ValueError(f"accel='mega' but no mega window for N={N} J={J}")
    f = cost_field(p, weights)
    S, key, rankf = f.S, f.key, f.rankf
    asg_init, gf_seed, mf_seed, seated = seed_incumbents(p, seeded)

    def mega(asg, rank_, may, gf_eff, mf_, rounds_cap):
        return f.run(
            kernels.mega_solve, jobs, asg, rank_, may, gf_eff, mf_, rounds_cap
        )

    if accel == "mega":

        def resolve_fn(asg, gf_eff, mf_):
            return mega(asg, rankf, jobs.valid, gf_eff, mf_, max_rounds)

    else:

        def resolve_fn(asg, gf_eff, mf_):
            # one global loop: budget exhaustion is the round counter
            # reaching the cap
            a2, g2, m2, r2 = run_rounds(
                f, jobs, asg, gf_eff, mf_, 0, rankf, max_rounds
            )
            return a2, g2, m2, r2, r2 >= max_rounds

    assigned, gpu_free, mem_free, rounds, capped = resolve_fn(
        asg_init, gf_seed, mf_seed
    )

    if seeded:
        # Preemption repair (kubeinfer_tpu/solver/core.py:905-1023):
        # while a seated lower-rank incumbent squats capacity a
        # higher-rank unplaced job needs, unseat the victims on the best
        # reclaimable node and re-solve.
        # The ``ever`` mask makes it monotone (at most #seated iterations).
        ever = torch.zeros(J, dtype=torch.bool, device=dev)
        it = 0
        while it < J:
            unpl = jobs.valid & (assigned < 0)
            min_unpl_rank = torch.where(unpl, rankf, RANK_INF).min()
            on_seat = seated & (assigned == jobs.current_node) & ~ever
            if not bool((on_seat & (rankf > min_unpl_rank)).any()):  # sync
                break
            j_star = torch.where(unpl, key, _I32MAX).argmin()
            victim = on_seat & (rankf > rankf[j_star])
            freed_g, freed_m = _node_sums(
                torch.where(victim, jobs.current_node, -1),
                jobs.gpu_demand, jobs.mem_demand, nodes,
            )
            can = (
                nodes.valid
                & (jobs.gpu_demand[j_star] <= gpu_free + freed_g + _EPS)
                & (jobs.mem_demand[j_star] <= mem_free + freed_m + _EPS)
                & (freed_g + freed_m > 0.0)
            )
            if not bool(can.any()):  # host sync: nothing reclaimable
                break
            n_star = torch.where(can, S[:, j_star], 3.4e38).argmin()
            unseat = victim & (jobs.current_node == n_star)
            ever = ever | unseat
            assigned = torch.where(unseat, -1, assigned)
            at_star = torch.arange(N, device=dev) == n_star
            gpu_free = torch.where(at_star, gpu_free + freed_g, gpu_free)
            mem_free = torch.where(at_star, mem_free + freed_m, mem_free)
            assigned, gpu_free, mem_free, r2, capped2 = resolve_fn(
                assigned, torch.where(nodes.valid, gpu_free, -1.0), mem_free
            )
            rounds = rounds + r2
            capped = capped | capped2
            it += 1

    # Gang repair + fill, only when a gang is incomplete or a window ran
    # out of rounds with progress still possible.
    incomplete_gang = ((jobs.gang_id >= 0) & jobs.valid & (assigned < 0)).any()
    budget_capped = capped & ((assigned < 0) & jobs.valid).any()
    if bool(incomplete_gang | budget_capped):  # host sync
        assigned, gpu_free, mem_free = _gang_repair(p, assigned)
        rankf_fill = torch.where(
            (jobs.gang_id >= 0) & (assigned < 0), RANK_INF, rankf
        )
        fillable = (assigned < 0) & jobs.valid & (jobs.gang_id < 0)
        gf_fill = torch.where(nodes.valid, gpu_free, -1.0)
        if accel == "mega":
            # the per-window cap W + 1 lets every window reach its
            # fixpoint (each progress round places >= 1 job); seeded with
            # the current assignment, so the output IS the merged result
            assigned, gpu_free, mem_free, r_f, _ = mega(
                assigned, rankf_fill, fillable, gf_fill, mem_free, W + 1
            )
            rounds = rounds + r_f
        else:
            # one round per fillable job plus one: every progress round
            # places >= 1 job, so the fixpoint comes before the cap
            cap = int(rounds) + int(fillable.sum()) + 1  # host sync
            assigned, gpu_free, mem_free, rounds = run_rounds(
                f, jobs, assigned, gf_fill, mem_free, int(rounds),
                rankf_fill, cap,
            )
    gpu_free = torch.where(nodes.valid, gpu_free, 0.0)
    placed = ((assigned >= 0) & jobs.valid).sum().to(torch.int32)
    if not isinstance(rounds, torch.Tensor):
        # the pipelined loop counts on the host; a fill kernel writes the
        # count where a copy of a host int would sync
        rounds = torch.full((), rounds, dtype=torch.int32, device=dev)
    return Assignment(assigned, gpu_free, mem_free, rounds, placed)


def auction_benefit(p: Problem, weights: ScoreWeights) -> torch.Tensor:
    """f32[J, N] auction benefit (higher is better): minus the static and
    best-fit costs where the whole remaining node capacity fits the job,
    ``-INFEASIBLE`` elsewhere (kubeinfer_tpu/solver/core.py:1346-1359)."""
    jobs, nodes = p.jobs, p.nodes
    feas = (
        (jobs.gpu_demand[:, None] <= nodes.gpu_free[None, :] + _EPS)
        & (jobs.mem_demand[:, None] <= nodes.mem_free[None, :] + _EPS)
        & nodes.valid[None, :]
        & jobs.valid[:, None]
    )
    cost = _static_cost_t(p, weights).T + _fit_cost(p, weights)
    return torch.where(feas, -cost, -INFEASIBLE).contiguous()


def solve_auction(
    p: Problem,
    weights: ScoreWeights = ScoreWeights(),
    eps: float = 0.01,
    max_iters: int = 512,
    device: str | torch.device | None = None,
    accel: str = "auto",
) -> Assignment:
    """Auction assignment (policy ``jax-auction``): one replica per node,
    the placed jobs within ``J * (eps + kernels.TIE_TOL)`` of the optimal total
    cost (kubeinfer_tpu/solver/core.py:1317-1442 explains the hash
    tie-break and the stagnation exit). Priority does not move the result.

    The loop is ``kernels.auction_solve``: one kernel launch for CUDA
    tensors, whatever the shape. The reference runs its one-launch kernel
    only where the TPU allows (J % 8, N % 128 and a VMEM-resident field,
    ``_auction_accel``); that is a limit of the TPU, not of the card, and
    since the kernel and its plain version are bitwise equal the choice
    cannot change a result. ``accel`` steers only the greedy fill's main
    loop (``resolve_accel``).

    After the loop the gang repair runs always; when a valid job was left
    unplaced (decided before the repair), the fill re-offers the repaired
    capacity to the unplaced non-gang jobs through ``solve_greedy`` on a
    sub-problem, and its placements are merged. ``rounds`` is the
    auction's iteration count only. The free capacities come from the
    gang repair without a fill, and from the fill's solve with one."""
    dev = resolve_device(device)
    p = p.to(dev)
    jobs, nodes = p.jobs, p.nodes
    J = jobs.valid.shape[0]
    N = nodes.valid.shape[0]
    resolve_accel(accel, J, N)  # an unknown accel fails before any work
    benefit = auction_benefit(p, weights)
    tiebreak = auction_tiebreak(J, N, dev)
    assigned, iters = kernels.auction_solve(
        benefit, tiebreak, jobs.valid, eps, max_iters=max_iters
    )
    del benefit, tiebreak
    needs_fill = bool((jobs.valid & (assigned < 0)).any())  # host sync
    assigned, gpu_free, mem_free = _gang_repair(p, assigned)
    if needs_fill:
        fillable = (assigned < 0) & jobs.valid & (jobs.gang_id < 0)
        sub = Problem(
            jobs=replace(jobs, valid=fillable),
            nodes=replace(nodes, gpu_free=gpu_free, mem_free=mem_free),
        )
        out = solve_greedy(sub, weights, device=dev, accel=accel)
        assigned = torch.where(fillable & (out.node >= 0), out.node, assigned)
        gpu_free, mem_free = out.gpu_free, out.mem_free
    placed = ((assigned >= 0) & jobs.valid).sum().to(torch.int32)
    return Assignment(assigned, gpu_free, mem_free, iters, placed)


def solve(
    p: Problem,
    policy: str = "jax-greedy",
    weights: ScoreWeights = ScoreWeights(),
    seeded: bool = True,
    device: str | torch.device | None = None,
    accel: str = "auto",
) -> Assignment:
    """Dispatch by schedulerPolicy value (the batched policies only);
    ``seeded`` applies to the greedy solve, as in the reference."""
    if policy == "jax-greedy":
        return solve_greedy(
            p, weights, seeded=seeded, device=device, accel=accel
        )
    if policy == "jax-auction":
        return solve_auction(p, weights, device=device, accel=accel)
    raise ValueError(
        f"unknown solver policy {policy!r}; 'native-greedy' is dispatched "
        "by the SchedulerBackend layer, not the solver"
    )
