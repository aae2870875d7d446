"""The class-serialised greedy ("mega") loop: plain PyTorch and CUDA.

Counterpart of the mega section of ``kubeinfer_tpu/solver/pallas_kernels.py``
(``mega_window``, ``_mega_round_math``, ``mega_solve_pallas``,
``mega_rounds_jnp``). The job axis arrives priority-sorted and is cut
into W-wide windows; each window runs settlement rounds to a fixpoint —
in-window per-node priority fence, packed ``(quantized cost << bits) |
node`` min bid per job, per-node joint-fit/winner accept, capacity
update — while the capacity vectors carry from one window to the next.

``mega_rounds`` is the plain version; ``mega_solve`` launches the
hand-written kernel in ``csrc/mega_solve.cu`` for a CUDA tensor and
takes the plain version only for a CPU tensor. The two are bit-identical
as long as the demand sums are exact (small dyadic demands — integers,
halves, quarters), the same premise the reference's kernel/twin parity
rests on.
"""

from __future__ import annotations

import ctypes

import torch

_I32MAX = 0x7FFFFFFF
_EPS = 1e-4
RANK_INF = 1e9

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
        r = 0
        while prog and r < max_rounds:
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


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"{name}: want {dtype}{list(shape)}, got {t.dtype}{list(t.shape)}"
        )
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def mega_solve(
    s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
    gf_eff, mf, vg, vm, *, max_rounds, q_lo, q_scale, q_max, node_idx_bits,
):
    """The mega loop on the device the tensors are on: for CUDA tensors
    ONE cooperative launch of ``csrc/mega_solve.cu`` that runs every
    window and every round; for CPU tensors the plain ``mega_rounds``.
    Same arguments and results as ``mega_rounds``.

    ``mega_solve.launches`` counts kernel launches (and nothing else)."""
    if s_t.device.type == "cpu":
        return mega_rounds(
            s_t, d, md, accept_key, rankf, current_node, asg_init, may_bid,
            gf_eff, mf, vg, vm, max_rounds=max_rounds, q_lo=q_lo,
            q_scale=q_scale, q_max=q_max, node_idx_bits=node_idx_bits,
        )
    if s_t.device.type != "cuda":
        raise ValueError(f"mega_solve: unsupported device {s_t.device}")
    from kubeinfer_tpu_torch.solver._build import load_kernel_library

    N, J = s_t.shape
    W = mega_window(N, J)
    if W is None:
        raise ValueError(f"no mega window for N={N} J={J}")
    dev = s_t.device
    _check("s_t", s_t, torch.float32, (N, J), dev)
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

    lib = load_kernel_library()
    asg = torch.empty(J, dtype=torch.int32, device=dev)
    gf_out = torch.empty(N, dtype=torch.float32, device=dev)
    mf_out = torch.empty(N, dtype=torch.float32, device=dev)
    stats = torch.empty(2, dtype=torch.int32, device=dev)  # rounds, capped
    ws_f = torch.empty(8 * N, dtype=torch.float32, device=dev)
    ws_i = torch.empty(N + 2 * W + 16, dtype=torch.int32, device=dev)
    p = ctypes.c_void_p
    err = lib.mega_solve_launch(
        p(s_t.data_ptr()), p(d.data_ptr()), p(md.data_ptr()),
        p(accept_key.data_ptr()), p(rankf.data_ptr()),
        p(current_node.data_ptr()), p(asg_init.data_ptr()),
        p(may_bid.data_ptr()), p(gf_eff.data_ptr()), p(mf.data_ptr()),
        p(vg.data_ptr()), p(vm.data_ptr()),
        p(asg.data_ptr()), p(gf_out.data_ptr()), p(mf_out.data_ptr()),
        p(stats.data_ptr()), p(ws_f.data_ptr()), p(ws_i.data_ptr()),
        N, J, W, int(max_rounds),
        ctypes.c_float(q_lo), ctypes.c_float(q_scale), ctypes.c_float(q_max),
        int(node_idx_bits),
        p(torch.cuda.current_stream(dev).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(
            f"mega_solve launch failed: {lib.mega_solve_error_string(err)}"
        )
    mega_solve.launches += 1
    return asg, gf_out, mf_out, stats[0], stats[1] != 0


mega_solve.launches = 0
