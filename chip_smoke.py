#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port (``kubeinfer_tpu_torch``; nothing of JAX) through the
placement solve's entry points, builds its CUDA kernels from this
checkout, holds each kernel against its plain PyTorch version, checks the
solve's hard guarantees, and times it. Phases:

  (0) the card's name and power limit (nvidia-smi);
  (1) the nvcc build of every kernel of the solve, one nvcc per source,
      started together: mega_solve.cu and round_ops.cu;
  (2) mega_solve vs mega_rounds at the headline shape J=12288, N=1024 on
      the same tensors: a fresh solve, a fill with may_bid over a 25%-gang
      request, and a seeded churn re-solve with asg_init — every output
      bitwise equal;
  (3) the mega path: ``get_backend("jax-greedy").solve`` at 10k jobs x 1k
      nodes and the ``/solve`` handler at 32 x 8 and 1k x 128, with the
      launch counts reset just before and read just after; no overcommit,
      gangs all-or-nothing, a fixpoint, 10000 placed, and the assignment
      equal to the port's own device="cpu" solve. The 32 x 8 call pads to
      a 64 x 64 bucket, which is not 128-aligned: it runs the pipelined
      loop (round kernels), as the reference routes it;
  (4) times of the mega path: p50 pack + solve at 10k x 1k and 50k x 1k,
      the kernel and its plain version (CUDA events), and the serial
      native baseline;
  (5) fence, bid and accept vs fence_minrank, round_bids and dense_accept,
      bitwise, on the inputs of the first rounds of a real 10k jobs x 20k
      nodes solve (J=12288, N=24576, both accept passes; no mega window
      fits) and on every round of a 700 x 60 solve with 25% gangs (N=64,
      the halves group rule);
  (6) the pipelined path: ``get_backend("jax-greedy").solve`` at 10k x 20k
      fresh, with 25% gangs, and a 10% churn re-solve (seeded, with the
      preemption repair), launch counts reset just before and read just
      after; the same guarantees, and the card's solve equal to the
      device="cpu" solve at 1k x 20k, at 700 x 60 with 25% gangs, and at
      an overloaded 1000 x 60 with 25% gangs (gang repair + fill);
  (7) times of the pipelined path: p50 pack + solve at 10k x 20k, rounds,
      ms per round, launches and host syncs per solve, and each round
      kernel beside its plain version and its bound;
  (8) the ``kernels`` JSON line.

Exits non-zero, with no result line, when CUDA is unavailable or any
phase fails. Full numbers go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import collections
import json
import pathlib
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
ROUND_KERNELS = ("fence", "bid", "accept")


def build_request(J, N, seed=0, gang_fraction=0.0):
    """The headline benchmark's request generator (bench.py:build_request),
    on the port's SolveRequest."""
    from kubeinfer_tpu_torch.scheduler import SolveRequest

    rng = np.random.default_rng(seed)
    gang = np.full(J, -1, np.int32)
    if gang_fraction > 0:
        n_gang_jobs = int(J * gang_fraction)
        # gangs of 4; the last one shorter when the count is not a
        # multiple of 4 (bench.py's generator takes only multiples)
        gang[:n_gang_jobs] = np.repeat(
            np.arange(max(-(-n_gang_jobs // 4), 1)), 4
        )[:n_gang_jobs]
    return SolveRequest(
        job_gpu=rng.integers(1, 8, J).astype(np.float32),
        job_mem_gib=rng.integers(4, 64, J).astype(np.float32),
        job_priority=rng.integers(0, 8, J).astype(np.float32),
        job_gang=gang if gang_fraction > 0 else None,
        job_model=rng.integers(0, 256, J).astype(np.int32),
        node_gpu_free=np.full(N, 64.0, np.float32),
        node_mem_free_gib=np.full(N, 512.0, np.float32),
        node_cached=(rng.random((N, 256)) < 0.02).astype(np.uint8),
        node_topology=rng.integers(0, 16, N).astype(np.int32),
    )


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def problem_of(req, device):
    """The backend's own priority sort + pack + unpack, for kernel inputs."""
    from kubeinfer_tpu_torch.scheduler.backends import _descending_stable_perm
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    perm = _descending_stable_perm(np.asarray(req.job_priority))
    buf, _, _, J, N = pack_problem_arrays(
        job_gpu=req.job_gpu, job_mem_gib=req.job_mem_gib,
        job_priority=req.job_priority, job_gang=req.job_gang,
        job_model=req.job_model, job_current_node=req.job_current_node,
        node_gpu_free=req.node_gpu_free,
        node_mem_free_gib=req.node_mem_free_gib,
        node_topology=req.node_topology, node_cached=req.node_cached,
        job_perm=perm,
    )
    return unpack_problem(buf, J, N, device), perm


def cuda_ms(fn, reps, warmup=1):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_assignment(req, assignment, label, expect_all=False):
    """No overcommit, gangs all-or-nothing, and a fixpoint: no unplaced
    non-gang job fits any node's remaining capacity."""
    N = req.num_nodes
    placed = assignment >= 0
    check((assignment < N).all(), f"{label}: placed on a padding node")
    used_g = np.zeros(N)
    used_m = np.zeros(N)
    np.add.at(used_g, assignment[placed], req.job_gpu[placed])
    np.add.at(used_m, assignment[placed], req.job_mem_gib[placed])
    left_g = req.node_gpu_free - used_g
    left_m = req.node_mem_free_gib - used_m
    check((left_g >= -1e-3).all() and (left_m >= -1e-3).all(),
          f"{label}: overcommit")
    gang = req.job_gang
    if gang is not None:
        for g in np.unique(gang[gang >= 0]):
            members = placed[gang == g]
            check(members.all() or not members.any(),
                  f"{label}: gang {g} partially placed")
    for j in np.nonzero(~placed)[0]:
        if gang is not None and gang[j] >= 0:
            continue
        fits = (req.job_gpu[j] <= left_g + 1e-3) & (
            req.job_mem_gib[j] <= left_m + 1e-3
        )
        check(not fits.any(), f"{label}: job {j} unplaced but feasible")
    if expect_all:
        check(placed.all(), f"{label}: placed {int(placed.sum())}/{len(placed)}")
    return int(placed.sum())


def handler_body(J, N, seed, fractional):
    rng = np.random.default_rng(seed)
    gpu = (
        rng.choice([0.25, 0.5, 1.0, 2.0], J) if fractional
        else np.ones(J)
    )
    return {
        "policy": "jax-greedy",
        "jobs": {
            "gpu": gpu.tolist(),
            "memGib": rng.integers(1, 16, J).astype(float).tolist(),
            "priority": rng.integers(0, 4, J).astype(float).tolist(),
        },
        "nodes": {
            "gpuFree": [8.0] * N,
            "memFreeGib": [128.0] * N,
            "topology": rng.integers(0, 4, N).tolist(),
        },
    }


def reset_counts(kernels):
    """Set every kernel wrapper's launch count to 0."""
    for name in ("mega_solve", *ROUND_KERNELS):
        getattr(kernels, name).launches = 0


def round_counts(kernels):
    return {name: getattr(kernels, name).launches for name in ROUND_KERNELS}


class CheckedOps:
    """Round ops for ``core.run_rounds`` that run each kernel and its plain
    version on the same inputs, hold every output bitwise equal, and hand
    the kernel's result on. The inputs of each op's first call are kept
    for the timings."""

    def __init__(self, kernels):
        self.k = kernels
        self.calls = dict.fromkeys(ROUND_KERNELS, 0)
        self.max_err = dict.fromkeys(ROUND_KERNELS, 0.0)
        self.first = {}

    def _held(self, name, kern, plain, args, kw):
        self.first.setdefault(name, (args, kw))
        got, want = kern(*args, **kw), plain(*args, **kw)
        if not isinstance(got, tuple):
            got, want = (got,), (want,)
        for g, w in zip(got, want):
            err = float((g.double() - w.double()).abs().max())
            self.max_err[name] = max(self.max_err[name], err)
            check(torch_equal(g, w),
                  f"{name}: kernel != plain version, call {self.calls[name]}")
        self.calls[name] += 1
        return got if len(got) > 1 else got[0]

    def ops(self):
        from kubeinfer_tpu_torch.solver.core import RoundOps

        k = self.k
        return RoundOps(
            lambda *a, **kw: self._held("fence", k.fence, k.fence_minrank, a, kw),
            lambda *a, **kw: self._held("bid", k.bid, k.round_bids, a, kw),
            lambda *a, **kw: self._held(
                "accept", k.accept, k.dense_accept, a, kw),
        )


def torch_equal(a, b):
    import torch

    return a.dtype == b.dtype and torch.equal(a, b)


def count_syncs(fn):
    """Run ``fn`` under torch's CUDA sync debug mode; returns its result
    and its synchronising calls, counted by source line."""
    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        f"{pathlib.Path(w.filename).name}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message)
    )
    return out, sites


def churned(req, assignment, seed):
    """A 10% churn re-solve request (bench.py's churn cell): incumbents
    from a previous assignment, departed jobs replaced by new demands."""
    from kubeinfer_tpu_torch.scheduler import SolveRequest

    rng = np.random.default_rng(seed)
    current = np.asarray(assignment, np.int32).copy()
    departed = rng.random(req.num_jobs) < 0.1
    current[departed] = -1
    gpu = req.job_gpu.copy()
    gpu[departed] = rng.integers(1, 8, int(departed.sum()))
    return SolveRequest(**{**req.__dict__, "job_gpu": gpu,
                           "job_current_node": current})


def pipelined_phases(dev, backend, cpu_backend, kernels, record, card,
                     big=(10000, 20000), cpu_big=(1000, 20000), reps=10):
    """Phases (5)-(7): the round kernels against their plain versions, the
    pipelined path driven through the backend, and its times. Returns the
    round kernels' entries of the ``kernels`` line."""
    import torch

    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        cost_field,
        run_rounds,
        seed_incumbents,
    )
    from kubeinfer_tpu_torch.solver.kernels import RANK_INF, mega_window

    w = ScoreWeights()
    Jb, Nb = big
    req20 = build_request(Jb, Nb, seed=5)
    p20, _ = problem_of(req20, dev)
    J, N = p20.jobs.valid.shape[0], p20.nodes.valid.shape[0]
    check(mega_window(N, J) is None, f"{J}x{N} has a mega window")

    # (5) kernel vs plain: every round of the main loop of a fresh solve
    # at the full width, and of a 700 x 60 solve with 25% gangs (N=64)
    f20 = cost_field(p20, w)
    a0, g0, m0, _ = seed_incumbents(p20, False)
    chk = CheckedOps(kernels)
    _, _, _, r20 = run_rounds(f20, p20.jobs, a0, g0, m0, 0, f20.rankf, 64,
                              ops=chk.ops())
    print(f"[5] {J}x{N}: fence/bid/accept bitwise equal to their plain "
          f"versions over {r20} rounds ({chk.calls})")
    req700 = build_request(700, 60, seed=6, gang_fraction=0.25)
    p7, _ = problem_of(req700, dev)
    check(p7.nodes.valid.shape[0] == 64, "700x60 does not pad to N=64")
    f7 = cost_field(p7, w)
    a7, g7, m7, _ = seed_incumbents(p7, False)
    chk64 = CheckedOps(kernels)
    _, _, _, r7 = run_rounds(f7, p7.jobs, a7, g7, m7, 0, f7.rankf, 64,
                             ops=chk64.ops())
    print(f"[5] {p7.jobs.valid.shape[0]}x64 (halves group rule): bitwise "
          f"equal over {r7} rounds ({chk64.calls})")
    max_err = {k: max(chk.max_err[k], chk64.max_err[k]) for k in ROUND_KERNELS}
    record["round_checks"] = {"rounds_full": r20, "rounds_n64": r7,
                              "calls_full": chk.calls,
                              "calls_n64": chk64.calls}

    # (6) the pipelined path through the backend, counted
    req20g = build_request(Jb, Nb, seed=1, gang_fraction=0.25)
    reset_counts(kernels)
    res20 = backend.solve(req20)
    res20g = backend.solve(req20g)
    req20c = churned(req20, res20.assignment, seed=9)
    res20c = backend.solve(req20c)
    counts = round_counts(kernels)
    check(all(counts.values()), f"the pipelined path skipped a kernel: {counts}")
    check(kernels.mega_solve.launches == 0, "a no-window solve ran mega")
    placed = check_assignment(req20, res20.assignment, "10kx20k", True)
    placed_g = check_assignment(req20g, res20g.assignment, "10kx20k gang")
    placed_c = check_assignment(req20c, res20c.assignment, "10kx20k churn")
    stay = req20c.job_current_node >= 0
    moved = float((res20c.assignment[stay] != req20c.job_current_node[stay]).mean())
    print(f"[6] pipelined path, {Jb}x{Nb}: fresh placed {placed} rounds "
          f"{res20.rounds}; 25% gangs placed {placed_g} rounds {res20g.rounds};"
          f" 10% churn placed {placed_c} rounds {res20c.rounds}, survivors "
          f"moved {moved:.4f}; launches {counts}")
    for label, (jn, nn, kw) in {
        f"{cpu_big[0]}x{cpu_big[1]}": (*cpu_big, {"seed": 8}),
        "700x60 gang 0.25": (700, 60, {"seed": 6, "gang_fraction": 0.25}),
        # more demand than capacity: gangs end incomplete, so the gang
        # repair and the fill through run_rounds run on the card too
        "1000x60 gang 0.25": (1000, 60, {"seed": 6, "gang_fraction": 0.25}),
    }.items():
        req = build_request(jn, nn, **kw)
        card_res = backend.solve(req)
        t_cpu = time.perf_counter()
        cpu_res = cpu_backend.solve(req)
        cpu_s = time.perf_counter() - t_cpu
        check_assignment(req, card_res.assignment, label)
        check(np.array_equal(card_res.assignment, cpu_res.assignment)
              and card_res.rounds == cpu_res.rounds,
              f"{label}: card and CPU solves differ")
        print(f"[6] {label}: placed {card_res.placed} rounds "
              f"{card_res.rounds}, equal to the device='cpu' solve "
              f"({cpu_s:.1f} s on the host)")
        record[f"cpu_equal_{label}"] = {"placed": card_res.placed,
                                        "rounds": card_res.rounds,
                                        "cpu_s": cpu_s}
    record["pipelined_main_path"] = {
        "launches": counts, "placed": placed, "rounds": res20.rounds,
        "placed_gang": placed_g, "rounds_gang": res20g.rounds,
        "placed_churn": placed_c, "rounds_churn": res20c.rounds,
        "churn_moved": moved,
    }

    # (7) times
    for _ in range(2):
        backend.solve(req20)
    runs = [backend.solve(req20) for _ in range(reps)]
    p50 = statistics.median(r.solve_ms for r in runs)
    enc = statistics.median(r.extras["encode_ms"] for r in runs)
    reset_counts(kernels)
    _, sync_sites = count_syncs(lambda: backend.solve(req20))
    syncs = sum(sync_sites.values())
    per_solve = round_counts(kernels)
    # per-layer split of one solve: pack (host, above), one host-to-device
    # copy + views, the cost field, the round loop
    from kubeinfer_tpu_torch.scheduler.backends import _descending_stable_perm
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    buf, _, _, Jp, Np = pack_problem_arrays(
        **req20.__dict__, job_perm=_descending_stable_perm(req20.job_priority)
    )
    unpack_ms = cuda_ms(lambda: unpack_problem(buf, Jp, Np, dev), reps=10)
    field_ms = cuda_ms(lambda: cost_field(p20, w), reps=5)

    def loop():
        run_rounds(f20, p20.jobs, a0, g0, m0, 0, f20.rankf, 64)

    loop_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        loop_ms.append((time.perf_counter() - t0) * 1e3)
    loop_p50 = statistics.median(loop_ms)
    torch.cuda.reset_peak_memory_stats()
    backend.solve(req20)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # each kernel on the inputs of its first call (round 1), and its bound
    plain = {"fence": kernels.fence_minrank, "bid": kernels.round_bids,
             "accept": kernels.dense_accept}
    entries = []
    sources = {"fence": 587, "bid": 275, "accept": 420}
    also = {"fence": None, "bid": 513, "accept": 1125}
    for name in ROUND_KERNELS:
        args, kw = chk.first[name]
        ms = cuda_ms(lambda: getattr(kernels, name)(*args, **kw), reps=20)
        pms = cuda_ms(lambda: plain[name](*args, **kw), reps=3)
        if name == "fence":
            gf, mf, d, md, rank = args
            pairs = N * int((rank < RANK_INF).sum())
            moved_b = N * 12 + J * 12
            bound_ms = max(pairs / F32_OPS_PER_S,
                           moved_b / HBM_BYTES_PER_S) * 1e3
            bound_by = ("operations" if pairs / F32_OPS_PER_S
                        > moved_b / HBM_BYTES_PER_S else "bytes")
            note = f"{pairs} compare-selects (N x unplaced jobs) at 67 TFLOP/s"
        elif name == "bid":
            S, u, gf, mf, d, md, rank, minrank, cur = args
            finite = minrank < RANK_INF * 0.5
            max_mr = torch.where(finite, minrank, -1.0).max()
            active = (rank < RANK_INF * 0.5) & ((rank <= max_mr) | (cur >= 0))
            cols = int(active.sum())
            moved_b = cols * N * 4 + N * 16 + J * 16 + J * 8
            bound_ms = moved_b / HBM_BYTES_PER_S * 1e3
            bound_by = "bytes"
            note = f"S of {cols} active columns ({cols * N * 4} bytes)"
        else:
            moved_b = J * 16 + N * 8 + J + N * 8
            bound_ms = moved_b / HBM_BYTES_PER_S * 1e3
            bound_by = "bytes"
            note = "O(N + J) bytes; launch and barrier latency set the pace"
        print(f"[7] {card}: {name} {ms:.4f} ms/launch, plain {pms:.3f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by}: {note}), "
              f"{per_solve[name]} launches per {Jb}x{Nb} solve")
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "kubeinfer_tpu_torch/solver/csrc/round_ops.cu",
            "replaces": f"kubeinfer_tpu/solver/pallas_kernels.py:{sources[name]}",
            **({"also_replaces":
                f"kubeinfer_tpu/solver/pallas_kernels.py:{also[name]}"}
               if also[name] else {}),
            "launches": counts[name],
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": pms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "check": f"bitwise equal to its plain version at {J}x{N} "
                     "and at N=64",
        })
    print(f"[7] {card}: p50 pack+solve {Jb}x{Nb} {p50:.3f} ms (pack "
          f"{enc:.3f} ms), {res20.rounds} rounds, main loop {loop_p50:.3f} ms"
          f" = {loop_p50 / max(r20, 1):.3f} ms/round over {r20} rounds; per "
          f"solve: launches {per_solve}, {syncs} synchronising calls "
          f"{dict(sync_sites)}; layers: copy+unpack {unpack_ms:.3f} ms, cost "
          f"field {field_ms:.3f} ms; peak device memory {peak_gb:.2f} GB")
    record["pipelined_times"] = {
        "p50_ms": p50, "pack_ms": enc, "rounds": res20.rounds,
        "loop_ms": loop_p50, "loop_rounds": r20,
        "ms_per_round": loop_p50 / max(r20, 1),
        "launches_per_solve": per_solve, "syncs_per_solve": syncs,
        "sync_sites": dict(sync_sites), "unpack_ms": unpack_ms,
        "cost_field_ms": field_ms, "peak_gb": peak_gb,
    }
    return entries


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from kubeinfer_tpu_torch.scheduler import (
        NativeGreedyBackend,
        SolveRequest,
        get_backend,
        solve_service_handler,
    )
    from kubeinfer_tpu_torch.solver import _build, kernels
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        _gang_repair,
        cost_field,
        seed_incumbents,
    )
    from kubeinfer_tpu_torch.solver.kernels import RANK_INF, mega_window
    from kubeinfer_tpu_torch.solver.problem import (
        pack_problem_arrays,
        unpack_problem,
    )

    dev = torch.device("cuda")
    record: dict = {}

    # (0) the card
    card = card_line()
    record["card"] = card
    print(f"[0] card: {card}")

    # (1) the build, from this checkout's sources
    t0 = time.perf_counter()
    built = _build.build_all(["mega_solve", "round_ops"])
    for name in built:
        check(_build.load_kernel_library(name) is not None,
              f"{name} library did not load")
    build_s = time.perf_counter() - t0
    record["build_s"] = build_s
    for name, (lib_path, report) in built.items():
        ptxas = [ln.strip() for ln in report.splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        print(f"[1] built {lib_path.name}; ptxas: {ptxas}")
    print(f"[1] both libraries built in parallel in {build_s:.2f} s")

    # (2) kernel vs plain at the headline shape, three cases
    w = ScoreWeights()
    req10 = build_request(10000, 1000)
    cases = {}

    p_a, perm_a = problem_of(req10, dev)
    f_a = cost_field(p_a, w)
    asg0, gf0, mf0, _ = seed_incumbents(p_a, False)
    cases["fresh"] = (f_a, p_a.jobs, asg0, f_a.rankf, p_a.jobs.valid,
                      gf0, mf0, 64)

    req_g = build_request(10000, 1000, seed=1, gang_fraction=0.25)
    p_g, _ = problem_of(req_g, dev)
    f_g = cost_field(p_g, w)
    a0, g0, m0, _ = seed_incumbents(p_g, False)
    main_g = f_g.run(kernels.mega_rounds, p_g.jobs, a0, f_g.rankf,
                     p_g.jobs.valid, g0, m0, 64)[0]
    # unplace 10% of the non-gang jobs, then repair + fill as the solve does
    rng = np.random.default_rng(7)
    drop = torch.from_numpy(rng.random(main_g.shape[0]) < 0.1).to(dev)
    drop &= p_g.jobs.gang_id < 0
    asg_g, gf_g, mf_g = _gang_repair(p_g, torch.where(drop, -1, main_g))
    jobs_g = p_g.jobs
    rank_fill = torch.where((jobs_g.gang_id >= 0) & (asg_g < 0), RANK_INF,
                            f_g.rankf)
    fillable = (asg_g < 0) & jobs_g.valid & (jobs_g.gang_id < 0)
    W = mega_window(p_g.nodes.valid.shape[0], jobs_g.valid.shape[0])
    cases["gang_fill"] = (
        f_g, jobs_g, asg_g, rank_fill, fillable,
        torch.where(p_g.nodes.valid, gf_g, -1.0), mf_g, W + 1,
    )

    fresh_plain = f_a.run(kernels.mega_rounds, p_a.jobs, asg0, f_a.rankf,
                          p_a.jobs.valid, gf0, mf0, 64)[0]
    J10 = req10.num_jobs
    current = np.empty(J10, np.int32)
    current[perm_a] = fresh_plain[:J10].cpu().numpy()
    departed = rng.random(J10) < 0.1
    current[departed] = -1
    churn_gpu = req10.job_gpu.copy()
    churn_gpu[departed] = rng.integers(1, 8, int(departed.sum()))
    req_c = SolveRequest(**{**req10.__dict__, "job_gpu": churn_gpu,
                            "job_current_node": current})
    p_c, _ = problem_of(req_c, dev)
    f_c = cost_field(p_c, w)
    a_c, g_c, m_c, _ = seed_incumbents(p_c, True)
    cases["churn_seeded"] = (f_c, p_c.jobs, a_c, f_c.rankf, p_c.jobs.valid,
                             g_c, m_c, 64)

    max_err = 0.0
    fresh_out = None
    for name, (f, jobs, asg, rank, may, gfe, mfe, cap) in cases.items():
        ko = f.run(kernels.mega_solve, jobs, asg, rank, may, gfe, mfe, cap)
        po = f.run(kernels.mega_rounds, jobs, asg, rank, may, gfe, mfe, cap)
        torch.cuda.synchronize()
        err = max(
            float((ko[0] - po[0]).abs().max()),
            float((ko[1] - po[1]).abs().max()),
            float((ko[2] - po[2]).abs().max()),
        )
        max_err = max(max_err, err)
        same = (
            torch.equal(ko[0], po[0]) and torch.equal(ko[1], po[1])
            and torch.equal(ko[2], po[2]) and int(ko[3]) == int(po[3])
            and bool(ko[4]) == bool(po[4])
        )
        print(f"[2] {name}: kernel rounds={int(ko[3])} capped={bool(ko[4])} "
              f"placed={int((ko[0] >= 0).sum())} plain rounds={int(po[3])} "
              f"bitwise_equal={same} max_abs_err={err}")
        check(same, f"mega_solve != mega_rounds in case {name}")
        record[f"case_{name}"] = {"rounds": int(ko[3]),
                                  "capped": bool(ko[4])}
        if name == "fresh":
            fresh_out = ko

    # (3) the main path, counted
    backend = get_backend("jax-greedy")
    cpu_backend = get_backend("jax-greedy", "cpu")
    reset_counts(kernels)
    res = backend.solve(req10)
    res_g = backend.solve(req_g)
    bodies = {
        "32x8": handler_body(32, 8, 3, fractional=False),
        "1kx128": handler_body(1000, 128, 4, fractional=True),
    }
    handled = {k: solve_service_handler(b) for k, b in bodies.items()}
    launches = kernels.mega_solve.launches
    check(launches > 0, "the main path never launched mega_solve")
    round_on_32 = {k: getattr(kernels, k).launches for k in ROUND_KERNELS}
    check(all(round_on_32.values()),
          "/solve 32x8 (a 64x64 bucket) did not run the pipelined loop")
    placed = check_assignment(req10, res.assignment, "10kx1k", True)
    check_assignment(req_g, res_g.assignment, "10kx1k gang 0.25")
    for k, out in handled.items():
        b = bodies[k]
        hreq = SolveRequest(
            job_gpu=np.asarray(b["jobs"]["gpu"], np.float32),
            job_mem_gib=np.asarray(b["jobs"]["memGib"], np.float32),
            node_gpu_free=np.asarray(b["nodes"]["gpuFree"], np.float32),
            node_mem_free_gib=np.asarray(b["nodes"]["memFreeGib"],
                                         np.float32),
        )
        n_placed = check_assignment(
            hreq, np.asarray(out["assignment"], np.int32), f"/solve {k}"
        )
        check(n_placed == out["placed"], f"/solve {k}: placed miscounted")
        cpu_out = solve_service_handler(b, device="cpu")
        check(cpu_out["assignment"] == out["assignment"],
              f"/solve {k}: card and CPU assignments differ")
        path = "pipelined loop" if k == "32x8" else "mega"
        print(f"[3] /solve {k}: placed {out['placed']}/{len(out['assignment'])}"
              f" rounds {out['rounds']}, equal to the CPU solve ({path})")
    print(f"[3] /solve 32x8 ran the pipelined loop: launches {round_on_32}")
    t_cpu = time.perf_counter()
    res_cpu = cpu_backend.solve(req10)
    cpu_s = time.perf_counter() - t_cpu
    check(np.array_equal(res_cpu.assignment, res.assignment),
          "10kx1k: card and CPU assignments differ")
    kernels.mega_solve.launches = 0
    backend.solve(req10)
    launches_10k = kernels.mega_solve.launches
    print(f"[3] jax-greedy 10kx1k: placed {placed}/{J10} rounds {res.rounds}"
          f" mega_solve launches {launches} on the main path "
          f"({launches_10k} per 10kx1k solve); equal to the device='cpu' "
          f"solve ({cpu_s:.1f} s on the host)")
    record["main_path"] = {"launches": launches,
                           "launches_per_10k_solve": launches_10k,
                           "placed": placed, "rounds": res.rounds}

    # (4) times
    def p50_solve(req, reps):
        for _ in range(2):
            backend.solve(req)
        ms = [backend.solve(req) for _ in range(reps)]
        return (statistics.median(r.solve_ms for r in ms),
                statistics.median(r.extras["encode_ms"] for r in ms))

    p50_10k, enc_10k = p50_solve(req10, 20)
    req50 = build_request(50000, 1000)
    p50_50k, enc_50k = p50_solve(req50, 10)
    res50 = backend.solve(req50)
    check_assignment(req50, res50.assignment, "50kx1k")
    f, jobs, asg, rank, may, gfe, mfe, cap = cases["fresh"]
    kernel_ms = cuda_ms(
        lambda: f.run(kernels.mega_solve, jobs, asg, rank, may, gfe, mfe,
                      cap), reps=20)
    plain_ms = cuda_ms(
        lambda: f.run(kernels.mega_rounds, jobs, asg, rank, may, gfe, mfe,
                      cap), reps=3)
    # per-layer split of one 10k x 1k solve: pack (host, above), one
    # host-to-device copy + views, the cost field, the mega loop
    buf, _, _, Jp, Np = pack_problem_arrays(
        **{k: v for k, v in req10.__dict__.items()}, job_perm=perm_a
    )
    unpack_ms = cuda_ms(lambda: unpack_problem(buf, Jp, Np, dev), reps=20)
    field_ms = cuda_ms(lambda: cost_field(p_a, w), reps=20)
    native = NativeGreedyBackend()
    native.warmup()
    native_ms = statistics.median(
        native.solve(req10).solve_ms for _ in range(5)
    )
    N, J = f.S.shape
    W = mega_window(N, J)
    rounds = int(fresh_out[3])
    in_bytes = N * J * 4 + J * (6 * 4 + 1) + N * 4 * 4
    out_bytes = J * 4 + 2 * N * 4 + 8
    bound_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    rounds_bound_ms = (rounds * N * W * 4 + N * J * 4) / HBM_BYTES_PER_S * 1e3
    print(f"[4] {card}: p50 pack+solve 10kx1k {p50_10k:.3f} ms "
          f"(pack {enc_10k:.3f} ms), 50kx1k {p50_50k:.3f} ms "
          f"(pack {enc_50k:.3f} ms, placed {res50.placed}); mega_solve "
          f"{kernel_ms:.3f} ms/launch ({rounds} rounds, {J // W} windows), "
          f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
          f"(rounds x window {rounds_bound_ms:.4f} ms); native_p50_ms "
          f"{native_ms:.3f}; layers: copy+unpack {unpack_ms:.3f} ms, "
          f"cost field {field_ms:.3f} ms")
    record["times"] = {
        "p50_10k_ms": p50_10k, "pack_10k_ms": enc_10k,
        "p50_50k_ms": p50_50k, "pack_50k_ms": enc_50k,
        "placed_50k": res50.placed, "rounds_50k": res50.rounds,
        "mega_ms": kernel_ms, "mega_rounds": rounds, "windows": J // W,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "rounds_bound_ms": rounds_bound_ms, "native_p50_ms": native_ms,
        "cpu_solve_10k_s": cpu_s, "unpack_10k_ms": unpack_ms,
        "cost_field_10k_ms": field_ms,
    }

    round_entries = pipelined_phases(dev, backend, cpu_backend, kernels,
                                     record, card)

    # (8) the kernels line
    kline = {"kernels": [{
        "name": "mega_solve",
        "route": "cuda",
        "source": "kubeinfer_tpu_torch/solver/csrc/mega_solve.cu",
        "replaces": "kubeinfer_tpu/solver/pallas_kernels.py:909",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes",
        "library_ms": None,
        "check": "bitwise equal to mega_rounds in 3 cases at 12288x1024",
    }, *round_entries]}
    record.update(kline)
    out_dir = pathlib.Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps(kline))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
