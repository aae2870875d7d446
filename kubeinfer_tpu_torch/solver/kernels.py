"""The solver's device work: plain PyTorch and CUDA.

Four algorithms, as in ``kubeinfer_tpu/solver``:

- The class-serialised ("mega") loop, counterpart of the mega section of
  ``pallas_kernels.py`` (``mega_window``, ``_mega_round_math``,
  ``mega_solve_pallas``, ``mega_rounds_jnp``). The job axis arrives
  priority-sorted and is cut into W-wide windows; each window runs
  settlement rounds to a fixpoint — in-window per-node priority fence,
  packed ``(quantized cost << bits) | node`` min bid per job, per-node
  joint-fit/winner accept, capacity update — while the capacity vectors
  carry from one window to the next. ``mega_rounds`` is the plain
  version; ``mega_solve`` launches ``csrc/mega_solve.cu`` on the grid
  ``mega_plan`` chooses; ``mega_walk`` mirrors the kernel's walk counts.
- The round ops of the pipelined loop (``core.run_rounds``), counterparts
  of ``core._fence_minrank``, ``core._round_bids_jnp`` and
  ``core._dense_accept`` and of the Pallas kernels that replace them on
  the TPU (``fence_minrank_pallas``, ``bid_reduce_pallas`` →
  ``bid_select_pallas``, ``accept_phase_pallas`` →
  ``accept_flags_pallas``). ``fence_minrank``, ``round_bids`` and
  ``dense_accept`` are the plain versions; ``fence``, ``bid`` and
  ``accept`` launch the kernels of ``csrc/round_ops.cu``; ``fence_walk``
  and ``bid_walk`` mirror what the fence and bid kernels read.
- The Jacobi auction loop of the ``jax-auction`` policy, counterpart of
  ``core._auction_loop_jnp`` and of ``pallas_kernels.auction_solve``:
  ``auction_rounds`` is the plain version, ``auction_solve`` launches
  ``csrc/auction.cu`` on the kernel ``auction_plan`` chooses;
  ``auction_walk`` mirrors the kernel's walk counts.
- The route solve's masked row argmax, counterpart of
  ``pallas_kernels.route_pick_jnp``/``route_pick_pallas``:
  ``route_pick_plain`` is the plain version, ``route_pick`` launches
  ``csrc/route_pick.cu``.

Each wrapper takes its plain version only for a CPU tensor; for a CUDA
tensor it launches its kernel or raises. Kernel and plain version are
bit-identical as long as the demand sums are exact (small dyadic demands
— integers, halves, quarters), the same premise the reference's
kernel/twin parity rests on; the auction and the route pick sum nothing,
so they are bit-identical on any input. Each wrapper's ``launches``
attribute counts its kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kubeinfer_tpu_torch import _build

_I32MAX = 0x7FFFFFFF
_EPS = 1e-4
RANK_INF = 1e9
# The auction's "infeasible" benefit magnitude; -INFEASIBLE is its NEG.
INFEASIBLE = 1e9
# Values within TIE_TOL of a job's best count as tied for the hash
# tie-break; the loop stops after STALE_ITERS iterations without a net
# placement (kubeinfer_tpu/solver/core.py:70-82 says why).
TIE_TOL = 1e-5
STALE_ITERS = 16
# The route pick's finite "-inf" for masked entries.
ROUTE_NEG = -3e38

# Window budget: W is the widest 128-multiple dividing J whose [N, W] f32
# slice of the cost field fits 8 MiB. This is an ALGORITHM constant, not a
# memory budget on this card: W decides which jobs share a window (and so
# settle against each other's bids), so it fixes the result. Keeping the
# reference's value keeps the port's assignments equal to the reference's.
_MEGA_S_BYTES = 8 * 1024 * 1024


def mega_window(N: int, J: int) -> int | None:
    """Class-window width: the largest 128-multiple dividing J whose
    [N, W] f32 window fits ``_MEGA_S_BYTES``; the one sub-128 bucket
    (J=64) gets a single window. None when no window fits."""
    if N % 8:
        return None
    fit = _MEGA_S_BYTES // (4 * N)
    wmax = min(J, fit // 128 * 128)
    if J % 128 == 0 and wmax >= 128:
        for w in range(wmax, 0, -128):
            if J % w == 0:
                return w
    if J == 64 and fit >= J:
        return J
    return None


def mega_round_math(
    Sq: torch.Tensor,  # [N, W] pre-quantized cost window (S - q_lo) * q_scale
    d: torch.Tensor,  # [W] gpu demand
    md: torch.Tensor,  # [W] mem demand
    key: torch.Tensor,  # [W] i32 accept key
    rank: torch.Tensor,  # [W] f32 fence rank (RANK_INF for invalid)
    cur: torch.Tensor,  # [W] i32 incumbent node (-1 = none)
    may: torch.Tensor,  # [W] bool job may bid
    asg: torch.Tensor,  # [W] i32 assigned node (-1 = unplaced)
    gf: torch.Tensor,  # [N] gpu free (invalid nodes folded to -1)
    mf: torch.Tensor,  # [N] mem free
    vg: torch.Tensor,  # [N] fit-pressure weights
    vm: torch.Tensor,  # [N]
    *,
    q_scale: float,
    q_max: float,
    node_idx_bits: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One settlement round of a window (``_mega_round_math``). Returns
    ``(asg, gf, mf, progress)``; ``progress`` is a 0-d bool tensor."""
    N = Sq.shape[0]
    dev = Sq.device
    big = torch.tensor(_I32MAX, dtype=torch.int32, device=dev)
    unpl = may & (asg < 0)
    feas = (
        (d[None, :] <= (gf + _EPS)[:, None])
        & (md[None, :] <= (mf + _EPS)[:, None])
        & unpl[None, :]
    )
    rank_eff = torch.where(unpl, rank, RANK_INF)
    r_lo = rank_eff.min()
    r_hi = torch.where(unpl, rank, -RANK_INF).max()
    if bool(r_lo < r_hi):
        minrank = torch.where(feas, rank_eff[None, :], RANK_INF).amin(dim=1)
    else:
        minrank = torch.full((N,), RANK_INF, dtype=torch.float32, device=dev)
    n_glob = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    # home-bid fence exemption: an incumbent may always bid its own node
    feas = feas & (
        (rank_eff[None, :] <= minrank[:, None]) | (cur[None, :] == n_glob)
    )
    uq = (vg * gf + vm * mf) * q_scale
    q = torch.clamp(Sq + uq[:, None], 0.0, q_max)
    packed = torch.where(
        feas, (q.to(torch.int32) << node_idx_bits) | n_glob, big
    )
    prim = packed.amin(dim=0)
    node_mask = (1 << node_idx_bits) - 1
    choice = torch.where(prim != big, prim & node_mask, N)
    mine = choice[None, :] == n_glob
    tg = torch.where(mine, d[None, :], 0.0).sum(dim=1)
    tm = torch.where(mine, md[None, :], 0.0).sum(dim=1)
    win = torch.where(mine, key[None, :], big).amin(dim=1)
    fits_all = (tg <= gf + _EPS) & (tm <= mf + _EPS)
    ok = mine & (fits_all[:, None] | (key[None, :] == win[:, None]))
    accept = ok.any(dim=0)
    used_g = torch.where(ok, d[None, :], 0.0).sum(dim=1)
    used_m = torch.where(ok, md[None, :], 0.0).sum(dim=1)
    asg = torch.where(accept, choice, asg)
    gf = gf - used_g
    mf = mf - used_m
    still = may & (asg < 0)
    min_d = torch.where(still, d, 3.4e38).min()
    progress = accept.any() & still.any() & (min_d <= gf.max() + _EPS)
    return asg, gf, mf, progress


def mega_rounds(
    s_t: torch.Tensor,  # [N, J] f32 cost field (priority-sorted job axis)
    d: torch.Tensor,  # f32[J]
    md: torch.Tensor,  # f32[J]
    accept_key: torch.Tensor,  # i32[J]
    rankf: torch.Tensor,  # f32[J]
    current_node: torch.Tensor,  # i32[J]
    asg_init: torch.Tensor,  # i32[J] seeded assignment (-1 = unplaced)
    may_bid: torch.Tensor,  # bool[J]
    gf_eff: torch.Tensor,  # f32[N] (invalid nodes folded to -1)
    mf: torch.Tensor,  # f32[N]
    vg: torch.Tensor,  # f32[N]
    vm: torch.Tensor,  # f32[N]
    *,
    max_rounds: int,
    q_lo: float,
    q_scale: float,
    q_max: float,
    node_idx_bits: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the whole mega loop (``mega_rounds_jnp``).
    Returns ``(assigned i32[J], gpu_free f32[N], mem_free f32[N], rounds
    i32 0-d, capped bool 0-d)``; ``max_rounds`` is a per-window budget.
    Branches on device values with Python control flow, so it syncs with
    the device every round: it is the reference, not the fast path."""
    return _mega_loop(
        s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
        gf_eff, mf, vg, vm, max_rounds=max_rounds, q_lo=q_lo,
        q_scale=q_scale, q_max=q_max, node_idx_bits=node_idx_bits,
    )


def mega_walk(
    s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
    gf_eff, mf, vg, vm, *, max_rounds, q_lo, q_scale, q_max, node_idx_bits,
) -> torch.Tensor:
    """Plain mirror of what ``mega_solve``'s kernel adds to
    ``mega_solve.walk_counter``: int64[4] on the CPU, the windows whose
    entry test held, the rounds, the fenced rounds (r_lo < r_hi at the
    round's start) and the grid barriers (one a launch, two a round). Runs
    the plain loop; same arguments as ``mega_rounds``."""
    walk = [0, 0, 0, 1]
    _mega_loop(
        s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
        gf_eff, mf, vg, vm, max_rounds=max_rounds, q_lo=q_lo,
        q_scale=q_scale, q_max=q_max, node_idx_bits=node_idx_bits, walk=walk,
    )
    return torch.tensor(walk, dtype=torch.int64)


def _mega_loop(
    s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
    gf_eff, mf, vg, vm, *, max_rounds, q_lo, q_scale, q_max, node_idx_bits,
    walk=None,
):
    N, J = s_t.shape
    W = mega_window(N, J)
    if W is None:
        raise ValueError(f"no mega window for N={N} J={J}")
    asg_full = torch.full((J,), -1, dtype=torch.int32, device=s_t.device)
    gf, mf_c = gf_eff, mf
    rounds, capped = 0, False
    for col in range(0, J, W):
        w = slice(col, col + W)
        Sw = (s_t[:, w] - q_lo) * q_scale
        dw, mdw, mayw = d[w], md[w], may_bid[w]
        asg = asg_init[w]
        unpl0 = mayw & (asg < 0)
        prog = bool(
            unpl0.any()
            & (torch.where(unpl0, dw, 3.4e38).min() <= gf.max() + _EPS)
        )
        if walk is not None:
            walk[0] += int(prog)
        r = 0
        while prog and r < max_rounds:
            if walk is not None:
                unpl = mayw & (asg < 0)
                fenced = bool(
                    torch.where(unpl, rankf[w], RANK_INF).min()
                    < torch.where(unpl, rankf[w], -RANK_INF).max()
                )
                walk[1:] = [walk[1] + 1, walk[2] + fenced, walk[3] + 2]
            asg, gf, mf_c, p = mega_round_math(
                Sw, dw, mdw, accept_key[w], rankf[w], current_node[w],
                mayw, asg, gf, mf_c, vg, vm,
                q_scale=q_scale, q_max=q_max, node_idx_bits=node_idx_bits,
            )
            r += 1
            prog = bool(p)
        asg_full[w] = asg
        rounds += r
        capped = capped or prog
    dev = s_t.device
    return (
        asg_full, gf, mf_c,
        torch.tensor(rounds, dtype=torch.int32, device=dev),
        torch.tensor(capped, device=dev),
    )


# The mega kernel's launch plan (csrc/mega_solve.cu): MEGA_THREADS threads
# a block, one block an SM, each block's shared memory within the card's
# opt-in maximum (227 KB) less room for its static arrays; a thread
# compacts at most 32 active columns, so W <= 32 x MEGA_THREADS.
MEGA_THREADS = 512
MEGA_SMEM_LIMIT = 232448 - 1024


class MegaPlan(NamedTuple):
    blocks: int  # B, one per SM, each owning `rows` contiguous nodes
    rows: int  # R = N / B
    smem: int  # dynamic shared-memory bytes a block
    vec_smem: bool  # the window's job words and keys in shared memory


def mega_smem_bytes(rows: int, W: int, vec_smem: bool) -> int:
    """A block's shared memory (``smem_bytes`` in mega_solve.cu): the
    window's rows twice (row stride W + 4), two mbarriers, 16 bytes of
    node words and 40 of state a row, the job words and keys, two 16-bit
    active lists and the owner rows."""
    b = 2 * rows * (W + 4) * 4 + 16 + rows * 16
    b += W * 20 if vec_smem else 0
    return b + rows * 40 + W * 6


def mega_plan(N: int, W: int, sms: int) -> MegaPlan:
    """The launch of ``mega_solve``'s kernel for N nodes and windows of W
    columns on a card with ``sms`` SMs: the most blocks (at most one an
    SM) that split the nodes evenly, and the job words in shared memory
    where they fit. Raises for a shape it does not cover."""
    blocks = max(b for b in range(1, min(sms, N) + 1) if N % b == 0)
    rows = N // blocks
    if rows <= MEGA_THREADS and W <= 32 * MEGA_THREADS and W % 4 == 0:
        for vec_smem in (True, False):
            smem = mega_smem_bytes(rows, W, vec_smem)
            if smem <= MEGA_SMEM_LIMIT:
                return MegaPlan(blocks, rows, smem, vec_smem)
    raise ValueError(f"mega_plan: no launch plan for N={N}, W={W} on "
                     f"{sms} SMs")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _check_lean(specs, dev) -> None:
    """``_check`` of each (name, tensor, dtype, shape) on ``dev`` at a few
    attribute reads a tensor (the accept wrapper runs twice a round)."""
    for name, t, dtype, shape in specs:
        if (t.dtype != dtype or t.shape != shape or t.device != dev
                or not t.is_contiguous()):
            _check(name, t, dtype, shape, dev)  # raises


_sms: dict = {}  # SM counts by device index


def _kernel_lib(t: torch.Tensor, name: str, lib_name: str):
    """The kernel library ``lib_name`` for a CUDA tensor (built at first
    use); None for a CPU tensor, where the wrapper ``name`` takes its plain
    version; raises for any other device."""
    kind = t.device.type
    if kind == "cpu":
        return None
    if kind != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    # a loaded library without the loader's lock (a dict read)
    lib = _build._libs.get(lib_name)
    return lib if lib is not None else _build.load_kernel_library(lib_name)


def _sm_count(dev: torch.device) -> int:
    sms = _sms.get(dev.index)
    if sms is None:
        sms = _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return sms


def mega_solve(
    s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
    gf_eff, mf, vg, vm, *, max_rounds, q_lo, q_scale, q_max, node_idx_bits,
):
    """The mega loop on the device the tensors are on: for CUDA tensors
    ONE cooperative launch of ``csrc/mega_solve.cu`` that runs every
    window and every round, planned by ``mega_plan``; for CPU tensors the
    plain ``mega_rounds``. Same arguments and results as ``mega_rounds``.

    ``mega_solve.launches`` counts kernel launches (and nothing else).
    Where ``mega_solve.walk_counter`` holds an int64 CUDA tensor of four
    elements, the kernel adds its walk to it (``mega_walk`` mirrors it)."""
    lib = _kernel_lib(s_t, "mega_solve", "mega_solve")
    if lib is None:
        return mega_rounds(
            s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
            gf_eff, mf, vg, vm, max_rounds=max_rounds, q_lo=q_lo,
            q_scale=q_scale, q_max=q_max, node_idx_bits=node_idx_bits,
        )
    N, J = s_t.shape
    W = mega_window(N, J)
    if W is None:
        raise ValueError(f"no mega window for N={N} J={J}")
    dev = s_t.device
    _check("s_t", s_t, torch.float32, (N, J), dev)
    if s_t.data_ptr() % 16:
        raise ValueError("s_t must start on a 16-byte boundary")
    for name, t, dt in (
        ("d", d, torch.float32), ("md", md, torch.float32),
        ("accept_key", accept_key, torch.int32),
        ("rankf", rankf, torch.float32),
        ("current_node", current_node, torch.int32),
        ("asg_init", asg_init, torch.int32), ("may_bid", may_bid, torch.bool),
    ):
        _check(name, t, dt, (J,), dev)
    for name, t in (("gf_eff", gf_eff), ("mf", mf), ("vg", vg), ("vm", vm)):
        _check(name, t, torch.float32, (N,), dev)
    if node_idx_bits < (N - 1).bit_length() or node_idx_bits > 30:
        raise ValueError(f"node_idx_bits={node_idx_bits} cannot index N={N}")
    plan = mega_plan(N, W, _sm_count(dev))
    walked = mega_solve.walk_counter
    if walked is not None:
        _check("walk_counter", walked, torch.int64, (4,), dev)

    asg = torch.empty(J, dtype=torch.int32, device=dev)
    gf_out = torch.empty(N, dtype=torch.float32, device=dev)
    mf_out = torch.empty(N, dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)  # rounds, capped
    # the launch's packed job words (16 bytes a job), prim by round parity,
    # and a progress slot a block
    ws = torch.empty(4 * J + 2 * W + 2 * plan.blocks, dtype=torch.int32,
                     device=dev)
    p = ctypes.c_void_p
    err = lib.mega_solve_launch(
        p(s_t.data_ptr()), p(d.data_ptr()), p(md.data_ptr()),
        p(accept_key.data_ptr()), p(rankf.data_ptr()),
        p(current_node.data_ptr()), p(asg_init.data_ptr()),
        p(may_bid.data_ptr()), p(gf_eff.data_ptr()), p(mf.data_ptr()),
        p(vg.data_ptr()), p(vm.data_ptr()),
        p(asg.data_ptr()), p(gf_out.data_ptr()), p(mf_out.data_ptr()),
        p(stats.data_ptr()), p(ws.data_ptr()),
        p(0 if walked is None else walked.data_ptr()),
        N, J, W, int(max_rounds),
        ctypes.c_float(q_lo), ctypes.c_float(q_scale), ctypes.c_float(q_max),
        int(node_idx_bits), plan.blocks, plan.rows, int(plan.vec_smem),
        p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"mega_solve_launch failed: {lib.error_string(err)}")
    mega_solve.launches += 1
    return asg, gf_out, mf_out, stats[0], stats[1] != 0


mega_solve.launches = 0
mega_solve.walk_counter = None


# --- the pipelined loop's round ops ----------------------------------------


def _feasible(gf, mf, d, md):
    """[N, J] joint fit of every job on every node, with the f32 slack."""
    return (d[None, :] <= (gf + _EPS)[:, None]) & (
        md[None, :] <= (mf + _EPS)[:, None]
    )


def fence_minrank(
    gf: torch.Tensor,  # f32[N] gpu free (invalid nodes folded to -1)
    mf: torch.Tensor,  # f32[N]
    d: torch.Tensor,  # f32[J]
    md: torch.Tensor,  # f32[J]
    rankf_eff: torch.Tensor,  # f32[J] fence rank, RANK_INF = may not bid
) -> torch.Tensor:
    """f32[N] per-node fence minimum: the lowest rank among the jobs that
    find the node feasible (``core._fence_minrank``)."""
    return torch.where(
        _feasible(gf, mf, d, md), rankf_eff[None, :], RANK_INF
    ).amin(dim=1)


def bid_group_size(N: int) -> int:
    """Nodes per bid group (``core._round_bids_jnp``'s rule): 16 when N is
    128-aligned (the Pallas kernel's output), halves when N is even, and
    single nodes — the exact second-smallest bid — when N is odd."""
    if N % 128 == 0:
        return 16
    if N % 2 == 0:
        return N // 2
    return 1


def round_bids(
    S: torch.Tensor,  # f32[N, J] resident cost field
    u: torch.Tensor,  # f32[N] live best-fit pressure
    gf: torch.Tensor,  # f32[N] (invalid nodes folded to -1)
    mf: torch.Tensor,  # f32[N]
    d: torch.Tensor,  # f32[J]
    md: torch.Tensor,  # f32[J]
    rankf_eff: torch.Tensor,  # f32[J] fence rank, RANK_INF = may not bid
    minrank: torch.Tensor,  # f32[N] fence minimum
    current_node: torch.Tensor,  # i32[J] incumbent node, -1 = none
    *,
    q_lo: float,
    q_scale: float,
    q_max: float,
    node_idx_bits: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One pass over S -> (primary, alternate) packed i32 bids per job
    (``core._round_bids_jnp``). The primary is the job's least packed
    ``(quantized cost << node_idx_bits) | node`` over the nodes it may
    bid; the alternate is the least bid outside the primary's node group
    (``bid_group_size``). BIG (i32 max) means no bid."""
    N, J = S.shape
    dev = S.device
    big = torch.tensor(_I32MAX, dtype=torch.int32, device=dev)
    n_col = torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    # home-bid fence exemption: an incumbent may always bid its own node
    allowed = (
        _feasible(gf, mf, d, md)
        & (
            (rankf_eff[None, :] <= minrank[:, None])
            | (current_node[None, :] == n_col)
        )
        & (rankf_eff[None, :] < RANK_INF * 0.5)
    )
    q = torch.clamp((S + u[:, None] - q_lo) * q_scale, 0.0, q_max)
    packed = torch.where(allowed, (q.to(torch.int32) << node_idx_bits) | n_col, big)
    groups = N // bid_group_size(N)
    if groups == N:  # odd N: exclude the primary itself
        prim = packed.amin(dim=0)
        alt = torch.where(packed == prim[None, :], big, packed).amin(dim=0)
        return prim, alt
    per_group = packed.view(groups, N // groups, J).amin(dim=1)
    prim = per_group.amin(dim=0)
    prim_group = per_group.argmin(dim=0)
    g_iota = torch.arange(groups, device=dev)[:, None]
    alt = torch.where(g_iota == prim_group[None, :], big, per_group).amin(dim=0)
    return prim, alt


def accept_reduce(
    choice: torch.Tensor,  # i32[J] node index, or N = no bid
    key: torch.Tensor,  # i32[J] accept key (low bits: job index)
    d: torch.Tensor,  # f32[J]
    md: torch.Tensor,  # f32[J]
    N: int,
) -> tuple[torch.Tensor, ...]:
    """Per-node ``(gpu total, mem total, winner key, winner gpu, winner
    mem)`` over the node's bidders (``core._accept_reduce_jnp``). The
    winner's demand is gathered through the job index in the winner key's
    low bits, clamped into range as JAX's gather clamps."""
    J = choice.shape[0]
    dev = choice.device
    idx_mask = (1 << max((J - 1).bit_length(), 1)) - 1
    mine = choice[None, :] == torch.arange(N, dtype=torch.int32, device=dev)[:, None]
    tot_gpu = torch.where(mine, d[None, :], 0.0).sum(dim=1)
    tot_mem = torch.where(mine, md[None, :], 0.0).sum(dim=1)
    big = torch.tensor(_I32MAX, dtype=torch.int32, device=dev)
    win_key = torch.where(mine, key[None, :], big).amin(dim=1)
    has_win = win_key != big
    win_j = torch.where(has_win, win_key & idx_mask, J - 1).clamp(0, J - 1).long()
    win_gpu = torch.where(has_win, d[win_j], 0.0)
    win_mem = torch.where(has_win, md[win_j], 0.0)
    return tot_gpu, tot_mem, win_key, win_gpu, win_mem


def dense_accept(
    choice: torch.Tensor,  # i32[J] node index, or N = no bid
    key: torch.Tensor,  # i32[J]
    d: torch.Tensor,  # f32[J]
    md: torch.Tensor,  # f32[J]
    gf: torch.Tensor,  # f32[N] the capacities the bids must fit
    mf: torch.Tensor,  # f32[N]
    ws: AcceptWorkspace | None = None,  # the kernel's; unused here
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One accept pass -> ``(accept bool[J], used_gpu f32[N], used_mem
    f32[N])`` (``core._dense_accept``): a node whose bidders jointly fit
    accepts them all, else only its least-key bidder, if that one fits.
    ``ws`` is taken, and ignored, so that the kernel's callers can pass
    their workspace to either."""
    N = gf.shape[0]
    tot_g, tot_m, win_key, win_g, win_m = accept_reduce(choice, key, d, md, N)
    fits_all = (tot_g <= gf + _EPS) & (tot_m <= mf + _EPS)
    fits_win = (win_key != _I32MAX) & (win_g <= gf + _EPS) & (win_m <= mf + _EPS)
    used_g = torch.where(fits_all, tot_g, torch.where(fits_win, win_g, 0.0))
    used_m = torch.where(fits_all, tot_m, torch.where(fits_win, win_m, 0.0))
    mine = choice[None, :] == torch.arange(N, dtype=torch.int32, device=gf.device)[:, None]
    accept = (
        mine
        & (fits_all[:, None] | (fits_win[:, None] & (win_key[:, None] == key[None, :])))
    ).any(dim=0)
    return accept, used_g, used_m


def _launch(lib, fn: str, *args) -> None:
    """Call one launcher of a kernel library; pointers and the stream are
    passed as c_void_p (None as a null pointer), floats as c_float, the
    rest as c_int."""
    conv = []
    for a in args:
        if isinstance(a, torch.Tensor):
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif a is None:
            conv.append(None)
        elif isinstance(a, float):
            conv.append(ctypes.c_float(a))
        else:
            conv.append(int(a))
    dev = next(a for a in args if isinstance(a, torch.Tensor)).device
    err = getattr(lib, fn)(
        *conv, ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    )
    if err != 0:
        raise RuntimeError(f"{fn} failed: {lib.error_string(err)}")


# The walks of the fence and bid kernels (csrc/round_ops.cu): their tile
# constants, and plain mirrors of what they read, for the tests and
# chip_smoke; nothing on the main path calls the mirrors.
FENCE_BLOCK_NODES = 512  # kFenceBlockNodes: nodes a block, two a thread
FENCE_JOBS = 2048  # kFenceJobs: jobs a block stages (one split of J)
FENCE_CHUNK = 32  # kFenceChunk: jobs a warp sweeps or skips at once
BID_COLS = 128  # kBidCols: columns a block
BID_CHUNK = 512  # kBidChunk: nodes a block (one split of N)


def fence_walk(gf, mf, d, md, rankf_eff) -> torch.Tensor:
    """The fence kernel's sweeps: bool ``[splits, warps, chunks]``, True
    where warp w (nodes ``b * 512 + i * 256 + 32 * (w % 8) + lane``, b =
    w // 8, i in {0, 1}) sweeps chunk c (jobs ``s * 2048 + 32 * c`` on) of
    job split s. A warp sweeps a chunk when one of its nodes has a running
    minimum above the chunk's least rank below RANK_INF and free capacities
    at least its least demands; the running minimum starts at RANK_INF in
    each split. Its sum is what the kernel adds to ``fence.walk_counter``.
    Exact for finite demands and capacities."""
    N, J = gf.shape[0], d.shape[0]
    dev = gf.device
    blocks = -(-N // FENCE_BLOCK_NODES)
    splits = -(-J // FENCE_JOBS)
    chunks = FENCE_JOBS // FENCE_CHUNK
    Np, Jp = blocks * FENCE_BLOCK_NODES, splits * FENCE_JOBS
    inf = float("inf")
    g = torch.nn.functional.pad(gf + _EPS, (0, Np - N))
    m = torch.nn.functional.pad(mf + _EPS, (0, Np - N))
    live = torch.arange(Np, device=dev) < N
    jd = torch.nn.functional.pad(d, (0, Jp - J)).view(splits, chunks, -1)
    jm = torch.nn.functional.pad(md, (0, Jp - J)).view(splits, chunks, -1)
    jr = torch.nn.functional.pad(rankf_eff, (0, Jp - J), value=RANK_INF)
    jr = jr.view(splits, chunks, -1)
    act = jr < RANK_INF
    rmin = torch.where(act, jr, RANK_INF).amin(dim=2)  # [splits, chunks]
    dmin = torch.where(act, jd, inf).amin(dim=2)
    mmin = torch.where(act, jm, inf).amin(dim=2)
    mr = torch.full((splits, Np), RANK_INF, dtype=torch.float32, device=dev)
    visits = torch.zeros(splits, blocks * 8, chunks, dtype=torch.bool,
                         device=dev)
    for c in range(chunks):
        need = live & ~((mr <= rmin[:, c, None]) | (g < dmin[:, c, None])
                        | (m < mmin[:, c, None]))
        # node b * 512 + i * 256 + 32 * w + lane belongs to warp b * 8 + w
        warp = need.view(splits, blocks, 2, 8, 32).any(dim=4).any(dim=2)
        visits[:, :, c] = warp.view(splits, -1)
        swept = warp.view(splits, blocks, 1, 8, 1).expand(
            splits, blocks, 2, 8, 32).reshape(splits, Np)
        fits = (jd[:, None, c, :] <= g[None, :, None]) & (
            jm[:, None, c, :] <= m[None, :, None])
        low = torch.where(fits, jr[:, None, c, :], RANK_INF).amin(dim=2)
        mr = torch.where(swept, torch.minimum(mr, low), mr)
    return visits


def bid_walk(rankf_eff, minrank, current_node):
    """The bid kernel's walk: ``(walk bool[splits, J], home bool[splits,
    J], entries, walks)``. Node chunk s (nodes ``512 s`` on) walks column j
    where its rank is below RANK_INF / 2 and at most the chunk's largest
    fence minimum below RANK_INF / 2 (-1 where there is none); a column
    that does not walk the chunk reads S only at its incumbent's node, if
    that lies in the chunk (``home``). ``entries`` is the number of
    (node, column) pairs the kernel tests (it reads S at the allowed ones
    among them) and ``walks`` the number of (chunk, 128-column tile)
    pairs walked: what the kernel adds to ``bid.walk_counter``."""
    N, J = minrank.shape[0], rankf_eff.shape[0]
    dev = minrank.device
    splits = -(-N // BID_CHUNK)
    lo = torch.arange(splits, device=dev) * BID_CHUNK
    hi_n = torch.clamp(lo + BID_CHUNK, max=N)
    v = torch.where(minrank < RANK_INF * 0.5, minrank, -1.0)
    v = torch.nn.functional.pad(v, (0, splits * BID_CHUNK - N),
                                value=float("-inf"))
    hi = v.view(splits, BID_CHUNK).amax(dim=1)
    alive = rankf_eff < RANK_INF * 0.5
    walk = alive[None, :] & (rankf_eff[None, :] <= hi[:, None])
    cur = current_node[None, :]
    home = (alive[None, :] & ~walk & (cur >= lo[:, None])
            & (cur < hi_n[:, None]))
    entries = int((walk.sum(dim=1) * (hi_n - lo)).sum() + home.sum())
    tiles = -(-J // BID_COLS)
    walked = torch.nn.functional.pad(walk, (0, tiles * BID_COLS - J))
    walks = int(walked.view(splits, tiles, BID_COLS).any(dim=2).sum())
    return walk, home, entries, walks


def fence(gf, mf, d, md, rankf_eff):
    """``fence_minrank`` on the tensors' device: for CUDA tensors one
    launch of the fence kernel of ``csrc/round_ops.cu``. Where
    ``fence.walk_counter`` holds an int64 CUDA tensor of one element, the
    launch adds to it the chunk sweeps its warps take (``fence_walk``'s
    sum)."""
    lib = _kernel_lib(gf, "fence", "round_ops")
    if lib is None:
        return fence_minrank(gf, mf, d, md, rankf_eff)
    N, J = gf.shape[0], d.shape[0]
    for name, t in (("gf", gf), ("mf", mf)):
        _check(name, t, torch.float32, (N,), gf.device)
    for name, t in (("d", d), ("md", md), ("rankf_eff", rankf_eff)):
        _check(name, t, torch.float32, (J,), gf.device)
    walked = fence.walk_counter
    if walked is not None:
        _check("walk_counter", walked, torch.int64, (1,), gf.device)
    out = torch.full((N,), RANK_INF, dtype=torch.float32, device=gf.device)
    _launch(lib, "fence_launch", gf, mf, d, md, rankf_eff, out, walked, N, J)
    fence.launches += 1
    return out


fence.launches = 0
fence.walk_counter = None


def bid(
    S, u, gf, mf, d, md, rankf_eff, minrank, current_node, *,
    q_lo, q_scale, q_max, node_idx_bits,
):
    """``round_bids`` on the tensors' device: for CUDA tensors one launch
    of the bid kernel of ``csrc/round_ops.cu``, which reads S only where
    ``bid_walk`` says (the reference's column skip, exact when ``minrank``
    is the fence minimum of the same inputs, as ``core.run_rounds`` passes
    it), split over node chunks whose pairs fold into each job's word in
    the same launch. ``prim`` and ``alt`` are the two columns of one
    [J, 2] tensor.
    Where ``bid.walk_counter`` holds an int64 CUDA tensor of two elements,
    the launch adds ``bid_walk``'s entries and walks to them."""
    lib = _kernel_lib(S, "bid", "round_ops")
    if lib is None:
        return round_bids(
            S, u, gf, mf, d, md, rankf_eff, minrank, current_node,
            q_lo=q_lo, q_scale=q_scale, q_max=q_max,
            node_idx_bits=node_idx_bits,
        )
    N, J = S.shape
    dev = S.device
    _check("S", S, torch.float32, (N, J), dev)
    for name, t in (("u", u), ("gf", gf), ("mf", mf), ("minrank", minrank)):
        _check(name, t, torch.float32, (N,), dev)
    for name, t in (("d", d), ("md", md), ("rankf_eff", rankf_eff)):
        _check(name, t, torch.float32, (J,), dev)
    _check("current_node", current_node, torch.int32, (J,), dev)
    if node_idx_bits < (N - 1).bit_length() or node_idx_bits > 30:
        raise ValueError(f"node_idx_bits={node_idx_bits} cannot index N={N}")
    walked = bid.walk_counter
    if walked is not None:
        _check("walk_counter", walked, torch.int64, (2,), dev)
    # each job's (prim, alt) in one 8-byte word, which the node chunks'
    # blocks fold their pairs into
    out = torch.full((J, 2), _I32MAX, dtype=torch.int32, device=dev)
    _launch(
        lib, "bid_launch", S, u, gf, mf, d, md, rankf_eff, minrank,
        current_node, out, walked, N, J, bid_group_size(N),
        int(node_idx_bits), float(q_lo), float(q_scale), float(q_max),
    )
    bid.launches += 1
    return out[:, 0], out[:, 1]


bid.launches = 0
bid.walk_counter = None


class AcceptWorkspace:
    """The accept kernel's node accumulators: two halves of (gpu totals,
    mem totals, winner codes), N int32 words each, all zero at first. A
    launch accumulates into ``half``, which the launch before left zeroed,
    and zeroes the other; ``accept`` flips ``half`` after each launch. One
    workspace serves every accept call of a solve (``core.run_rounds``),
    in stream order."""

    __slots__ = ("buf", "half")

    def __init__(self, N: int, device) -> None:
        self.buf = torch.zeros(2 * 3 * N, dtype=torch.int32, device=device)
        self.half = 0


def accept(choice, key, d, md, gf, mf, ws=None):
    """``dense_accept`` on the tensors' device: for CUDA tensors one
    cooperative launch of the accept kernel of ``csrc/round_ops.cu`` with
    one grid barrier (bidder totals and winner by atomics into the half of
    ``ws`` the launch before left zeroed, then the node verdicts and the
    per-job flag, a gather through ``choice``). ``ws`` is an
    ``AcceptWorkspace`` of N nodes on the same device, used in stream
    order; without one the call allocates a zeroed one."""
    lib = _kernel_lib(choice, "accept", "round_ops")
    if lib is None:
        return dense_accept(choice, key, d, md, gf, mf, ws)
    N, J = gf.shape[0], choice.shape[0]
    dev = choice.device
    _check_lean((("choice", choice, torch.int32, (J,)),
                 ("key", key, torch.int32, (J,)),
                 ("d", d, torch.float32, (J,)),
                 ("md", md, torch.float32, (J,)),
                 ("gf", gf, torch.float32, (N,)),
                 ("mf", mf, torch.float32, (N,))), dev)
    if ws is None:
        ws = AcceptWorkspace(N, dev)
    elif ws.buf.shape != (6 * N,) or ws.buf.device != dev:
        raise ValueError(f"accept: a workspace of {ws.buf.shape[0] // 6} "
                         f"nodes on {ws.buf.device} for {N} nodes on {dev}")
    flags = torch.empty(J, dtype=torch.bool, device=dev)
    used_g, used_m = torch.empty(2, N, dtype=torch.float32,
                                 device=dev).unbind(0)
    # the raw handle of the current stream: torch.cuda.current_stream()
    # builds a Stream object, several us of host time a call
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    err = lib.accept_launch(
        choice.data_ptr(), key.data_ptr(), d.data_ptr(), md.data_ptr(),
        gf.data_ptr(), mf.data_ptr(), flags.data_ptr(), used_g.data_ptr(),
        used_m.data_ptr(), ws.buf.data_ptr(), ws.half, N, J, stream)
    if err != 0:
        raise RuntimeError(f"accept_launch failed: {lib.error_string(err)}")
    ws.half ^= 1
    accept.launches += 1
    return flags, used_g, used_m


accept.launches = 0


# --- the auction loop --------------------------------------------------------


def auction_rounds(
    benefit: torch.Tensor,  # f32[J, N]; -INFEASIBLE marks infeasible
    tiebreak: torch.Tensor,  # i32[J, N] from core.auction_tiebreak
    valid: torch.Tensor,  # bool[J]
    eps: float,
    *,
    max_iters: int,
    active_rows: list | None = None,
    near_entries: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the Jacobi auction loop (``core._auction_loop_jnp``):
    the same state, loop condition, stale counter and iteration count.
    Returns ``(assigned i32[J], iters i32 0-d)``. When ``active_rows`` is
    a list, the number of rows that take part in each iteration (the
    unassigned valid jobs) is appended to it; when ``near_entries`` is a
    list, the number of entries within TIE_TOL of their row's best value,
    over the rows that bid (the tie-break entries the bid target needs).
    Both feed the kernel's byte bound.

    Each iteration: every unassigned job's values ``benefit - price``,
    its best value, its bid target (the largest tie-break hash among the
    values within TIE_TOL of the best, lowest node on equal hashes), the
    best value off that target (floored at NEG, the masked slot's value)
    and its bid ``(price[target] + (best - second)) + eps``; every node's
    highest bid wins it, the lowest job on equal bids; the previous owner
    is evicted. The per-node maximum and the winner are ``scatter_reduce``s
    where the reference compares against an [N, J] broadcast; both select
    the same values. The loop condition is one host sync per iteration."""
    J, N = benefit.shape
    dev = benefit.device
    f32 = torch.float32
    neg = torch.tensor(-INFEASIBLE, dtype=f32, device=dev)
    tol = torch.tensor(TIE_TOL, dtype=f32, device=dev)
    eps_t = torch.tensor(eps, dtype=f32, device=dev)
    n_iota = torch.arange(N, dtype=torch.int32, device=dev)
    j_iota = torch.arange(J, dtype=torch.int32, device=dev)
    assigned = torch.full((J,), -1, dtype=torch.int32, device=dev)
    owner = torch.full((N,), -1, dtype=torch.int32, device=dev)
    prices = torch.zeros(N, dtype=f32, device=dev)
    it, progress, pending_best, stale = 0, True, J + 1, 0
    n_pending = int(valid.sum())  # host sync
    while progress and n_pending > 0 and it < max_iters and stale < STALE_ITERS:
        if active_rows is not None:
            active_rows.append(n_pending)
        unassigned = (assigned < 0) & valid
        value = torch.where(unassigned[:, None], benefit - prices[None, :], neg)
        best_v = value.amax(dim=1)
        near = value >= (best_v - tol)[:, None]
        tb = torch.where(near, tiebreak, -1)
        best_n = torch.where(
            tb == tb.amax(dim=1, keepdim=True), n_iota[None, :], N
        ).amin(dim=1)
        second_v = torch.where(
            n_iota[None, :] == best_n[:, None], neg, value
        ).amax(dim=1)
        can_bid = unassigned & (best_v > neg * 0.5)
        if near_entries is not None:
            near_entries.append(int((near & can_bid[:, None]).sum()))
        bid = torch.where(
            can_bid, prices[best_n.long()] + (best_v - second_v) + eps_t, neg
        )
        # per-node highest bid and its lowest bidder; slot N collects the
        # rows that do not bid
        tgt = torch.where(can_bid, best_n, N).long()
        win_bid = torch.full((N + 1,), -INFEASIBLE, dtype=f32, device=dev)
        win_bid = win_bid.scatter_reduce(0, tgt, bid, "amax")
        top = can_bid & (bid == win_bid[tgt])
        winner = torch.full((N + 1,), J, dtype=torch.int32, device=dev)
        winner = winner.scatter_reduce(0, tgt, torch.where(top, j_iota, J), "amin")
        has = win_bid[:N] > neg * 0.5
        win_j = winner[:N]
        # each owner owns one node and each winner bid on one node, so the
        # evicted and the winning jobs are distinct; slot J is a sentinel
        evict = torch.zeros(J + 1, dtype=torch.bool, device=dev)
        evict[torch.where(has & (owner >= 0), owner, J).long()] = True
        assigned = torch.where(evict[:J], -1, assigned)
        owner = torch.where(has, win_j, owner)
        prices = torch.where(has, win_bid[:N], prices)
        won = torch.full((J + 1,), -1, dtype=torch.int32, device=dev)
        won[torch.where(has, win_j, J).long()] = n_iota
        assigned = torch.where(won[:J] >= 0, won[:J], assigned)
        it += 1
        # the stale counter follows the pending count: a war iteration
        # evicts as many as it places
        pend_t = ((assigned < 0) & valid).sum()
        progress, n_pending = torch.stack(
            [can_bid.any().to(pend_t.dtype), pend_t]
        ).tolist()  # host sync: the loop condition
        progress = bool(progress)
        stale = 0 if n_pending < pending_best else stale + 1
        pending_best = min(n_pending, pending_best)
    return assigned, torch.tensor(it, dtype=torch.int32, device=dev)


# The auction kernels' launch plan (csrc/auction.cu). The shared-state
# kernel runs AUCTION_THREADS threads a block, one block an SM, each holding
# price[N], owner[N], assigned[J] and the active list [J] in shared memory
# (8 bytes a node and a job) within the card's opt-in maximum less room for
# its static arrays, and a thread holds at most AUCTION_VMAX values of a
# row. Past that line the two-barrier kernel takes the call (the state in
# L2, two blocks an SM): a route chosen by shape.
AUCTION_THREADS = 512
AUCTION_VMAX = 32
AUCTION_SMEM_LIMIT = 232448 - 1024


class AuctionPlan(NamedTuple):
    route: str  # "shared" (one grid barrier an iteration) or "wide" (two)
    blocks: int  # "wide": as many as are co-resident, up to two an SM
    threads: int
    smem: int  # dynamic shared-memory bytes a block


def auction_plan(J: int, N: int, sms: int) -> AuctionPlan:
    """The launch of ``auction_solve`` for a [J, N] field on a card with
    ``sms`` SMs: the shared-state kernel on min(sms, J) blocks where a row
    fits a block's threads and the state fits its shared memory, else the
    two-barrier kernel."""
    smem = 8 * (N + J)
    if N <= AUCTION_THREADS * AUCTION_VMAX and smem <= AUCTION_SMEM_LIMIT:
        return AuctionPlan("shared", min(sms, J), AUCTION_THREADS, smem)
    return AuctionPlan("wide", 2 * sms, AUCTION_THREADS, 0)


def auction_deal(active: int, N: int, blocks: int) -> list[list[int]]:
    """The shared kernel's deal of an iteration's ``active`` rows (positions
    in the active list) over its groups: the group size G, a power of two
    from the least that holds a row (G x AUCTION_VMAX >= N) up to a whole
    block, is the most threads that still give every row a group; group g
    (block g // (512 / G)) walks positions g, g + groups, ... Returns each
    group's positions."""
    gmin = 32
    while gmin * AUCTION_VMAX < N:
        gmin *= 2
    fit = blocks * AUCTION_THREADS // active
    G = min(AUCTION_THREADS, max(gmin, 1 << (fit.bit_length() - 1)))
    groups = blocks * (AUCTION_THREADS // G)
    return [list(range(g, active, groups)) for g in range(groups)]


def auction_walk(benefit, tiebreak, valid, eps, *, max_iters,
                 plan: AuctionPlan) -> torch.Tensor:
    """Plain mirror of what ``auction_solve``'s kernel on ``plan`` adds to
    ``auction_solve.walk_counter``: int64[3] on the CPU, the rows walked
    (on the "shared" route the rows ``auction_deal`` gives the groups in
    each iteration, on the "wide" one every active row, a warp each), the
    tie-break entries read (the near entries of the rows that bid) and the
    grid barriers (one an iteration on the "shared" route; one a launch
    and two an iteration on the "wide" one). Runs the plain loop."""
    N = benefit.shape[1]
    active, near = [], []
    _, iters = auction_rounds(benefit, tiebreak, valid, eps,
                              max_iters=max_iters, active_rows=active,
                              near_entries=near)
    it = int(iters)
    if plan.route == "shared":
        rows = sum(len(pos) for a in active
                   for pos in auction_deal(a, N, plan.blocks))
        barriers = it
    else:
        rows, barriers = sum(active), 1 + 2 * it
    return torch.tensor([rows, sum(near), barriers], dtype=torch.int64)


def auction_solve(benefit, tiebreak, valid, eps, *, max_iters):
    """The auction loop on the device the tensors are on: for CUDA tensors
    ONE cooperative launch of ``csrc/auction.cu`` that runs every
    iteration, on the kernel ``auction_plan`` routes the shape to; for CPU
    tensors the plain ``auction_rounds``. Same arguments and results as
    ``auction_rounds`` (without ``active_rows`` and ``near_entries``); any
    (J, N) is taken.

    ``auction_solve.launches`` counts kernel launches (and nothing else).
    Where ``auction_solve.walk_counter`` holds an int64 CUDA tensor of three
    elements, the kernel adds its walk to it (``auction_walk`` mirrors
    it)."""
    lib = _kernel_lib(benefit, "auction_solve", "auction")
    if lib is None:
        return auction_rounds(benefit, tiebreak, valid, eps, max_iters=max_iters)
    J, N = benefit.shape
    dev = benefit.device
    if J < 1 or N < 1:
        raise ValueError(f"auction_solve: empty field {J}x{N}")
    _check_lean((("benefit", benefit, torch.float32, (J, N)),
                 ("tiebreak", tiebreak, torch.int32, (J, N)),
                 ("valid", valid, torch.bool, (J,))), dev)
    plan = auction_plan(J, N, _sm_count(dev))
    walked = auction_solve.walk_counter
    if walked is not None:
        _check("walk_counter", walked, torch.int64, (3,), dev)
    asg = torch.empty(J, dtype=torch.int32, device=dev)
    iters = torch.empty(1, dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    walk_ptr = None if walked is None else walked.data_ptr()
    if plan.route == "shared":
        # three key buffers of N rounded up to even u64 words; buffer 0
        # must arrive zeroed, the kernel clears the others as it goes
        keys = torch.zeros(3 * (N + (N & 1)), dtype=torch.int64, device=dev)
        vec = 4 if N % 4 == 0 and benefit.data_ptr() % 16 == 0 else 1
        err = lib.auction_shared_launch(
            benefit.data_ptr(), tiebreak.data_ptr(), valid.data_ptr(),
            asg.data_ptr(), iters.data_ptr(), keys.data_ptr(), walk_ptr,
            J, N, int(max_iters), float(eps), plan.blocks, plan.smem, vec,
            stream)
    else:
        # key u64[N] (2N ints), price f32[N], owner i32[N], 8 counters
        ws = torch.zeros(4 * N + 8, dtype=torch.int32, device=dev)
        err = lib.auction_launch(
            benefit.data_ptr(), tiebreak.data_ptr(), valid.data_ptr(),
            asg.data_ptr(), iters.data_ptr(), ws.data_ptr(), walk_ptr,
            J, N, int(max_iters), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"auction launch failed: {lib.error_string(err)}")
    auction_solve.launches += 1
    return asg, iters[0]


auction_solve.launches = 0
auction_solve.walk_counter = None


# --- the route pick ----------------------------------------------------------


def route_pick_plain(
    match: torch.Tensor,  # i32[B, R] match depth in blocks; -1 = ineligible
    bias: torch.Tensor,  # f32[R] per-replica bias
    active: torch.Tensor,  # bool[B] row still unassigned
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked row argmax (``route_pick_jnp``): ``(row max f32[B], first
    index of it i32[B])``; a row with no eligible replica gives
    ``(ROUTE_NEG, -1)``. The only arithmetic is one f32 add per entry."""
    B, R = match.shape
    dev = match.device
    neg = torch.tensor(ROUTE_NEG, dtype=torch.float32, device=dev)
    ok = (match >= 0) & active[:, None]
    s = torch.where(ok, match.to(torch.float32) + bias[None, :], neg)
    v = s.amax(dim=1)
    r_iota = torch.arange(R, dtype=torch.int32, device=dev)
    idx = torch.where(s == v[:, None], r_iota[None, :], _I32MAX).amin(dim=1)
    return v, torch.where(v > neg, idx, -1).to(torch.int32)


def route_pick(match, bias, active):
    """``route_pick_plain`` on the tensors' device: for CUDA tensors one
    launch of ``csrc/route_pick.cu`` (one warp per row).

    ``route_pick.launches`` counts kernel launches (and nothing else)."""
    lib = _kernel_lib(match, "route_pick", "route_pick")
    if lib is None:
        return route_pick_plain(match, bias, active)
    B, R = match.shape
    dev = match.device
    if B < 1 or R < 1:
        raise ValueError(f"route_pick: empty plane {B}x{R}")
    _check("match", match, torch.int32, (B, R), dev)
    _check("bias", bias, torch.float32, (R,), dev)
    _check("active", active, torch.bool, (B,), dev)
    val = torch.empty(B, dtype=torch.float32, device=dev)
    idx = torch.empty(B, dtype=torch.int32, device=dev)
    _launch(lib, "route_pick_launch", match, bias, active, val, idx, B, R)
    route_pick.launches += 1
    return val, idx


route_pick.launches = 0
