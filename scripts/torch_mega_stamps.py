"""Per-phase timeline of the port's mega or auction kernel on one card,
from inside the launch.

    python3 scripts/torch_mega_stamps.py [--kernel mega|auction]
        [--source PATH] [--out FILE]

Copies a ``mega_solve.cu`` or, with ``--kernel auction``, an
``auction.cu`` (by default the package's own), inserts a
``%globaltimer`` / ``clock64`` stamp taken by thread 0 of block 0 before
and after every ``grid.sync();`` line, at every ``// Phase X:`` comment and
after an ``if (fence) {`` line, builds the copy with the package's nvcc
flags, binds it in place of the package's library and runs it.

- mega: one 10k jobs x 1k nodes fresh solve (``chip_smoke.build_request``,
  12288 x 1024) through ``kernels.mega_solve``;
- auction: the whole-node fields of ``chip_smoke.py`` [9] at 1k x 1k
  (bucket 1024 x 1024) and 4096 x 4096 through ``kernels.auction_solve``.
  Here the copy also times every row walk: the thread that reaches a
  ``// the best value off best_n`` line adds the clock64 spans from the
  ``// pass 1`` and ``// pass 2`` lines before it (the row's two passes)
  to the bin of the grid barriers its block has passed, so the walks of
  each iteration add up on their own. It prints the walk's us an
  iteration in the busy first iteration and in the quiet ones, and the
  kernel's device time (``chip_smoke.device_ms``: a CUDA graph of 20
  launches) beside the stamped copy's CUDA-event time.

It prints the time block 0 spent between each pair of consecutive stamps,
summed over the launch and per round (iteration), and the launch's time by
CUDA events (20 launches without and with the stamps). The source must
keep the package's launcher signature. Card only.

Stamp names: ``sK<`` before and ``sK>`` after the K-th ``grid.sync();`` of
the source (block 0 reaches ``sK<`` when its own share of the phase is
done, so ``sK<->sK>`` is the barrier plus the wait for the slowest
block), ``X`` at ``// Phase X:``, ``F`` inside a fenced round.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import subprocess
import sys
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CAP = 65536
BINS = 4096

PRELUDE = r"""
__device__ unsigned long long g_stamp_t[%(cap)d];
__device__ long long g_stamp_c[%(cap)d];
__device__ int g_stamp_tag[%(cap)d];
__device__ int g_stamp_n;
// the auction's walk stamps: grid barriers each block has passed, and per
// count of barriers the walks' number, pass 1 and pass 2 clocks, and the
// longest walk
__device__ int g_block_sync_[1024];
__device__ unsigned long long g_walk_[%(bins)d][4];
__device__ __forceinline__ void walk_rec_(long long c1, long long c2,
                                          long long c3) {
  const int b = *(volatile int*)&g_block_sync_[blockIdx.x];
  if (b < %(bins)d) {
    atomicAdd(&g_walk_[b][0], 1ull);
    atomicAdd(&g_walk_[b][1], (unsigned long long)(c2 - c1));
    atomicAdd(&g_walk_[b][2], (unsigned long long)(c3 - c2));
    atomicMax(&g_walk_[b][3], (unsigned long long)(c3 - c1));
  }
}
__device__ __forceinline__ void stamp_(int tag) {
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const int i = g_stamp_n;
    if (i < %(cap)d) {
      unsigned long long t;
      asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
      g_stamp_t[i] = t;
      g_stamp_c[i] = clock64();
      g_stamp_tag[i] = tag;
      g_stamp_n = i + 1;
    }
  }
}
""" % {"cap": CAP, "bins": BINS}

EPILOGUE = r"""
extern "C" int stamps_fetch(void* t, void* c, void* tag, int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(n, g_stamp_n, sizeof(int));
  if (e != cudaSuccess) return e;
  const int k = *n < %(cap)d ? *n : %(cap)d;
  e = cudaMemcpyFromSymbol(t, g_stamp_t, k * sizeof(unsigned long long));
  if (e != cudaSuccess) return e;
  e = cudaMemcpyFromSymbol(c, g_stamp_c, k * sizeof(long long));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(tag, g_stamp_tag, k * sizeof(int));
}

extern "C" int stamps_reset() {
  const int zero = 0;
  static int zeros[1024];
  static unsigned long long wzeros[%(bins)d][4];
  cudaError_t e = cudaMemcpyToSymbol(g_block_sync_, zeros, sizeof(zeros));
  if (e != cudaSuccess) return e;
  e = cudaMemcpyToSymbol(g_walk_, wzeros, sizeof(wzeros));
  if (e != cudaSuccess) return e;
  return cudaMemcpyToSymbol(g_stamp_n, &zero, sizeof(int));
}

extern "C" int walks_fetch(void* out) {
  return cudaMemcpyFromSymbol(out, g_walk_, sizeof(g_walk_));
}
""" % {"cap": CAP, "bins": BINS}

SYNC = re.compile(r"^(\s*)grid\.sync\(\);\s*$")
PHASE = re.compile(r"^(\s*)// Phase ([A-Z]):")
FENCE = re.compile(r"^(\s*)if \(fence\) \{\s*$")
PASS = re.compile(r"^(\s*)// pass ([12])\b")
WALK_END = re.compile(r"^(\s*)// the best value off best_n\b")


def instrument(src: str, walks: bool = False) -> tuple[str, dict[int, str]]:
    """The stamped source and the name of each tag; with ``walks`` also
    the per-block barrier counts and the row walks' stamps."""
    names: dict[int, str] = {}
    out, k = [], 0
    for line in src.splitlines():
        m = SYNC.match(line)
        if m:
            ind = m.group(1)
            names[100 + k], names[200 + k] = f"s{k}<", f"s{k}>"
            out += [f"{ind}__syncthreads();", f"{ind}stamp_({100 + k});",
                    line, f"{ind}stamp_({200 + k});"]
            if walks:
                out += [f"{ind}if (threadIdx.x == 0) "
                        "++g_block_sync_[blockIdx.x];",
                        f"{ind}__syncthreads();"]
            k += 1
            continue
        m = PASS.match(line) if walks else None
        if m:
            out += [line, f"{m.group(1)}const long long w{m.group(2)}_ = "
                          "clock64();"]
            continue
        m = WALK_END.match(line) if walks else None
        if m:
            out += [line, f"{m.group(1)}walk_rec_(w1_, w2_, clock64());"]
            continue
        m = PHASE.match(line)
        if m:
            tag = 300 + ord(m.group(2)) - ord("A")
            names[tag] = m.group(2)
            out += [line, f"{m.group(1)}stamp_({tag});"]
            continue
        out.append(line)
        if FENCE.match(line):
            names[400] = "F"
            out.append(f"{FENCE.match(line).group(1)}  stamp_(400);")
    text = "\n".join(out) + "\n"
    # the stamp helper goes after the last #include
    last = max(m.end() for m in re.finditer(r"^#include .*$", text, re.M))
    return text[:last] + "\n" + PRELUDE + text[last:] + EPILOGUE, names


def build(src_path: pathlib.Path, out_dir: pathlib.Path, name: str):
    """Builds the stamped copy of ``src_path`` as kernel library ``name``."""
    from kubeinfer_tpu_torch import _build

    text, names = instrument(src_path.read_text(), walks=name == "auction")
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"{name}_stamped.cu"
    cu.write_text(text)
    lib_path = out_dir / f"lib{name}_stamped.so"
    cmd = [_build.nvcc_path(), *_build.nvcc_flags(name), "-o",
           str(lib_path), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    _build._declare(name, lib)
    lib.stamps_fetch.restype = ctypes.c_int
    lib.stamps_fetch.argtypes = [ctypes.c_void_p] * 4
    lib.stamps_reset.restype = ctypes.c_int
    lib.walks_fetch.restype = ctypes.c_int
    lib.walks_fetch.argtypes = [ctypes.c_void_p]
    return lib, names


def fetch(lib):
    import numpy as np

    t = np.zeros(CAP, np.uint64)
    c = np.zeros(CAP, np.int64)
    tag = np.zeros(CAP, np.int32)
    n = ctypes.c_int(0)
    err = lib.stamps_fetch(t.ctypes.data, c.ctypes.data, tag.ctypes.data,
                           ctypes.byref(n))
    if err:
        raise RuntimeError(f"stamps_fetch: {err}")
    k = min(n.value, CAP)
    return t[:k], c[:k], tag[:k]


def segments(t, c, tag, names):
    """Sum and count of block 0's time between consecutive stamps, by
    (from, to); clock64 deltas scaled to ns by the launch's own ratio."""
    ns_per_clk = float(t[-1] - t[0]) / float(c[-1] - c[0])
    acc = defaultdict(lambda: [0.0, 0])
    for i in range(1, len(tag)):
        key = f"{names[int(tag[i - 1])]}->{names[int(tag[i])]}"
        acc[key][0] += float(c[i] - c[i - 1]) * ns_per_clk / 1e3
        acc[key][1] += 1
    return {k: {"us": v[0], "count": v[1]} for k, v in acc.items()}, \
        float(t[-1] - t[0]) / 1e3, 1.0 / ns_per_clk


def print_segments(segs, per, unit):
    print(f"[stamps] {'segment':<14} {'count':>6} {'total us':>10} "
          f"{'us a ' + unit:>12} {'us each':>9}")
    for k, v in sorted(segs.items(), key=lambda kv: -kv[1]["us"]):
        print(f"[stamps] {k:<14} {v['count']:>6} {v['us']:>10.2f} "
              f"{v['us'] / max(per, 1):>12.3f} "
              f"{v['us'] / v['count']:>9.3f}")


def run_mega(args, cs, dev, card):
    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.solver import kernels
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        cost_field,
        seed_incumbents,
    )

    plain_lib = _build.load_kernel_library("mega_solve")
    stamped, names = build(pathlib.Path(args.source),
                           ROOT / "kubeinfer_tpu_torch" / "build" / "stamps",
                           "mega_solve")
    p, _ = cs.problem_of(cs.build_request(10000, 1000), dev)
    f = cost_field(p, ScoreWeights())
    asg0, gf0, mf0, _ = seed_incumbents(p, False)

    def solve():
        return f.run(kernels.mega_solve, p.jobs, asg0, f.rankf, p.jobs.valid,
                     gf0, mf0, 64)

    times = {}
    for label, lib in (("unstamped", plain_lib), ("stamped", stamped),
                       ("unstamped again", plain_lib)):
        _build._libs["mega_solve"] = lib
        times[label] = cs.cuda_ms(solve, reps=20)
    _build._libs["mega_solve"] = stamped
    solve()
    torch.cuda.synchronize()
    if stamped.stamps_reset():
        raise RuntimeError("stamps_reset failed")
    out = solve()
    torch.cuda.synchronize()
    t, c, tag = fetch(stamped)
    segs, span_us, clk_ghz = segments(t, c, tag, names)
    rounds = int(out[3])
    fenced = int((tag == 400).sum())
    print(f"[stamps] {card}; source {args.source}")
    print(f"[stamps] launch ms by CUDA events: " + ", ".join(
        f"{k} {v:.4f}" for k, v in times.items()))
    print(f"[stamps] rounds {rounds}, fenced rounds {fenced}, windows "
          f"{f.S.shape[1] // kernels.mega_window(*f.S.shape)}; block 0's "
          f"first to last stamp {span_us:.1f} us; SM clock {clk_ghz:.3f} GHz")
    print_segments(segs, rounds, "round")
    return {
        "card": card, "source": args.source, "times_ms": times,
        "rounds": rounds, "fenced_rounds": fenced, "span_us": span_us,
        "sm_clock_ghz": clk_ghz, "segments": segs,
        "stamps": [[names[int(g)], int(x)] for g, x in zip(tag, t)],
    }


def walk_bins(lib, clk_ghz):
    """The row walks by count of grid barriers passed: (bin, walks, pass 1
    us summed, pass 2 us summed, the longest walk us), bins with walks."""
    import numpy as np

    w = np.zeros((BINS, 4), np.uint64)
    if lib.walks_fetch(w.ctypes.data):
        raise RuntimeError("walks_fetch failed")
    us = 1e-3 / clk_ghz
    return [(b, int(w[b, 0]), float(w[b, 1]) * us, float(w[b, 2]) * us,
             float(w[b, 3]) * us) for b in range(BINS) if w[b, 0]]


def run_auction(args, cs, dev, card):
    import torch

    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.solver import kernels

    plain_lib = _build.load_kernel_library("auction")
    stamped, names = build(pathlib.Path(args.source),
                           ROOT / "kubeinfer_tpu_torch" / "build" / "stamps",
                           "auction")
    report = {"card": card, "source": args.source, "fields": {}}
    print(f"[stamps] {card}; source {args.source}")
    for J, N in ((1000, 1000), (4096, 4096)):
        b, t, v = cs.auction_inputs(cs.whole_node_request(J, N), dev)
        label = f"{J}x{N} whole-node ({b.shape[0]}x{b.shape[1]})"

        def solve():
            return kernels.auction_solve(b, t, v, 0.01, max_iters=512)

        times = {}
        _build._libs["auction"] = plain_lib
        times["device"] = cs.device_ms(solve)
        for lab, lib in (("unstamped", plain_lib), ("stamped", stamped),
                         ("unstamped again", plain_lib)):
            _build._libs["auction"] = lib
            times[lab] = cs.cuda_ms(solve, reps=20)
        _build._libs["auction"] = stamped
        solve()
        torch.cuda.synchronize()
        if stamped.stamps_reset():
            raise RuntimeError("stamps_reset failed")
        out = solve()
        torch.cuda.synchronize()
        _build._libs["auction"] = plain_lib
        iters = int(out[1])
        tg, c, tag = fetch(stamped)
        segs, span_us, clk_ghz = segments(tg, c, tag, names)
        syncs = sum(1 for g in tag if 100 <= int(g) < 200)
        bins = walk_bins(stamped, clk_ghz)
        busy, quiet = bins[0], bins[1:]
        nq = max(len(quiet), 1)
        walk = {
            "busy": {"bin": busy[0], "walks": busy[1], "pass1_us_sum":
                     busy[2], "pass2_us_sum": busy[3], "longest_us": busy[4]},
            "quiet": {"iterations": len(quiet),
                      "walks_a_iteration": sum(q[1] for q in quiet) / nq,
                      "longest_us_a_iteration": sum(q[4] for q in quiet) / nq,
                      "pass1_us_a_walk": sum(q[2] for q in quiet)
                      / max(sum(q[1] for q in quiet), 1),
                      "pass2_us_a_walk": sum(q[3] for q in quiet)
                      / max(sum(q[1] for q in quiet), 1)},
        }
        print(f"[stamps] {label}: {iters} iterations, {syncs} grid barriers "
              f"({syncs / max(iters, 1):.2f} an iteration); device "
              f"{times['device']:.4f} ms (a CUDA graph of 20), "
              f"{times['device'] * 1e3 / max(iters, 1):.2f} us an iteration; "
              f"by CUDA events: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items() if k != "device")
              + f"; block 0's first to last stamp {span_us:.1f} us; SM clock "
              f"{clk_ghz:.3f} GHz")
        print(f"[stamps] {label}: row walks, busy first iteration: "
              f"{busy[1]} walks, the longest {busy[4]:.3f} us, pass 1 "
              f"{busy[2] / busy[1]:.3f} and pass 2 {busy[3] / busy[1]:.3f} us "
              f"a walk; quiet iterations ({len(quiet)}): "
              f"{walk['quiet']['walks_a_iteration']:.1f} walks an iteration, "
              f"the longest {walk['quiet']['longest_us_a_iteration']:.3f} us, "
              f"pass 1 {walk['quiet']['pass1_us_a_walk']:.3f} and pass 2 "
              f"{walk['quiet']['pass2_us_a_walk']:.3f} us a walk")
        print_segments(segs, iters, "iteration")
        report["fields"][label] = {
            "iters": iters, "grid_barriers": syncs, "times_ms": times,
            "span_us": span_us, "sm_clock_ghz": clk_ghz, "segments": segs,
            "walks": walk, "walk_bins": bins,
        }
    return report


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("mega", "auction"), default="mega")
    ap.add_argument("--source", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    lib = "mega_solve" if args.kernel == "mega" else "auction"
    args.source = args.source or str(
        ROOT / "kubeinfer_tpu_torch" / "solver" / "csrc" / f"{lib}.cu")
    args.out = args.out or str(ROOT / "chiprun_out" /
                               f"{args.kernel}_stamps.json")
    if not torch.cuda.is_available():
        print("torch_mega_stamps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs

    dev = torch.device("cuda")
    card = cs.card_line()
    run = run_mega if args.kernel == "mega" else run_auction
    report = run(args, cs, dev, card)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
