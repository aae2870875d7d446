"""Per-phase timeline of the port's mega kernel on one card, from inside
the launch.

    python3 scripts/torch_mega_stamps.py [--source PATH] [--out FILE]

Copies a ``mega_solve.cu`` (by default the package's own), inserts a
``%globaltimer`` / ``clock64`` stamp taken by thread 0 of block 0 before
and after every ``grid.sync();`` line, at every ``// Phase X`` comment and
after an ``if (fence) {`` line, builds the copy with the package's nvcc
flags, binds it in place of the package's library, and runs one 10k jobs
x 1k nodes fresh solve (``chip_smoke.build_request``, 12288 x 1024) through
``kernels.mega_solve``. It prints the time block 0 spent between each pair
of consecutive stamps, summed over the launch and per round, and the
launch's time by CUDA events (20 launches without and with the stamps).
The source must keep the package's launcher signature. Card only.

Stamp names: ``sK<`` before and ``sK>`` after the K-th ``grid.sync();`` of
the source (block 0 reaches ``sK<`` when its own share of the phase is
done, so ``sK<->sK>`` is the barrier plus the wait for the slowest
block), ``X`` at ``// Phase X``, ``F`` inside a fenced round.
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

PRELUDE = r"""
__device__ unsigned long long g_stamp_t[%(cap)d];
__device__ long long g_stamp_c[%(cap)d];
__device__ int g_stamp_tag[%(cap)d];
__device__ int g_stamp_n;
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
""" % {"cap": CAP}

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
  return cudaMemcpyToSymbol(g_stamp_n, &zero, sizeof(int));
}
""" % {"cap": CAP}

SYNC = re.compile(r"^(\s*)grid\.sync\(\);\s*$")
PHASE = re.compile(r"^(\s*)// Phase ([A-Z])\b")
FENCE = re.compile(r"^(\s*)if \(fence\) \{\s*$")


def instrument(src: str) -> tuple[str, dict[int, str]]:
    """The stamped source and the name of each tag."""
    names: dict[int, str] = {}
    out, k = [], 0
    for line in src.splitlines():
        m = SYNC.match(line)
        if m:
            ind = m.group(1)
            names[100 + k], names[200 + k] = f"s{k}<", f"s{k}>"
            out += [f"{ind}__syncthreads();", f"{ind}stamp_({100 + k});",
                    line, f"{ind}stamp_({200 + k});"]
            k += 1
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


def build(src_path: pathlib.Path, out_dir: pathlib.Path):
    from kubeinfer_tpu_torch import _build

    text, names = instrument(src_path.read_text())
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "mega_solve_stamped.cu"
    cu.write_text(text)
    lib_path = out_dir / "libmega_solve_stamped.so"
    cmd = [_build.nvcc_path(), *_build.nvcc_flags("mega_solve"), "-o",
           str(lib_path), str(cu)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    _build._declare("mega_solve", lib)
    lib.stamps_fetch.restype = ctypes.c_int
    lib.stamps_fetch.argtypes = [ctypes.c_void_p] * 4
    lib.stamps_reset.restype = ctypes.c_int
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


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--source", default=str(
        ROOT / "kubeinfer_tpu_torch" / "solver" / "csrc" / "mega_solve.cu"))
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "mega_stamps.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mega_stamps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from kubeinfer_tpu_torch import _build
    from kubeinfer_tpu_torch.solver import kernels
    from kubeinfer_tpu_torch.solver.core import (
        ScoreWeights,
        cost_field,
        seed_incumbents,
    )

    dev = torch.device("cuda")
    card = cs.card_line()
    plain_lib = _build.load_kernel_library("mega_solve")
    stamped, names = build(pathlib.Path(args.source),
                           ROOT / "kubeinfer_tpu_torch" / "build" / "stamps")
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
    print(f"[stamps] {'segment':<14} {'count':>6} {'total us':>10} "
          f"{'us a round':>10} {'us each':>9}")
    for k, v in sorted(segs.items(), key=lambda kv: -kv[1]["us"]):
        print(f"[stamps] {k:<14} {v['count']:>6} {v['us']:>10.2f} "
              f"{v['us'] / max(rounds, 1):>10.3f} "
              f"{v['us'] / v['count']:>9.3f}")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({
        "card": card, "source": args.source, "times_ms": times,
        "rounds": rounds, "fenced_rounds": fenced, "span_us": span_us,
        "sm_clock_ghz": clk_ghz, "segments": segs,
        "stamps": [[names[int(g)], int(x)] for g, x in zip(tag, t)],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
