"""Builds and loads the port's CUDA kernels.

Each ``solver/csrc/*.cu`` and ``inference/csrc/*.cu`` is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface,
at first use, into the git-ignored ``build/`` directory beside this
file, and loaded with ctypes; every pointer and the stream cross as
``c_void_p``. A failed build raises: there is no fallback. Nothing here
runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

_HERE = pathlib.Path(__file__).resolve().parent
CSRC_DIRS = (_HERE / "solver" / "csrc", _HERE / "inference" / "csrc")
BUILD_DIR = _HERE / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# -fmad=false for the solver's kernels: their plain PyTorch versions round
# every multiply and add on its own and the kernels are held to them
# bitwise, so nvcc must not fuse them (the sources use __fmul_rn /
# __fadd_rn on the bid arithmetic as well, which nvcc never contracts).
# The attention kernels are held to a stated tolerance and may fuse.
_BITWISE = ("mega_solve", "round_ops", "auction", "route_pick")


def nvcc_flags(name: str) -> list[str]:
    return NVCC_FLAGS + (["-fmad=false"] if name in _BITWISE else [])


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError("nvcc not found on PATH or under CUDA_HOME")


def source(name: str) -> pathlib.Path:
    """``<name>.cu`` in one of the csrc directories."""
    for d in CSRC_DIRS:
        src = d / f"{name}.cu"
        if src.exists():
            return src
    raise ValueError(f"no kernel source {name}.cu under {CSRC_DIRS}")


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and nvcc's report (empty when cached)."""
    return build_all([name])[name]


def build_all(names: list[str]) -> dict[str, tuple[pathlib.Path, str]]:
    """``build`` for several sources, with one nvcc per stale source, all
    started together."""
    done, running = {}, {}
    for name in names:
        src = source(name)
        out = BUILD_DIR / f"lib{name}.so"
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            done[name] = (out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename: a concurrent build never
        # sees (or loads) a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp, str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
        )
        running[name] = (cmd, proc, tmp, out)
    failed = []
    for name, (cmd, proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{' '.join(cmd)} exited {proc.returncode}\n{stderr}")
            continue
        os.replace(tmp, out)
        done[name] = (out, stdout + stderr)
    if failed:
        raise KernelBuildError("\n".join(failed))
    return done


def load_kernel_library(name: str = "mega_solve") -> ctypes.CDLL:
    """Load (building if needed) one kernel library; cached per process."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path, _ = build(name)
        lib = ctypes.CDLL(str(path))
        _declare(name, lib)
        _libs[name] = lib
        return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# argument types of each library's launchers; every launcher returns a
# cudaError_t as int and takes the stream last
_SIGNATURES = {
    "mega_solve": {
        # S, d, md, key, rank, cur, asg0, may, gf0, mf0, vg, vm, asg, gf,
        # mf, stats, ws, walked (four int64 counters or null), N, J, W,
        # max_rounds, q_lo, q_scale, q_max, bits, blocks, rows, vec_smem
        # (kernels.mega_plan)
        "mega_solve_launch": [_P] * 18 + [_I] * 4 + [_F] * 3 + [_I] * 4
                             + [_P],
        # blocks, iters, out: grid barriers alone
        "mega_barrier_launch": [_I, _I, _P, _P],
    },
    "round_ops": {
        # gf, mf, d, md, rank, out, walked (an int64 counter or null), N, J
        "fence_launch": [_P] * 7 + [_I, _I, _P],
        # S, u, gf, mf, d, md, rank, minrank, cur, out (int32 [J, 2]:
        # prim, alt), walked (two int64 counters or null), N, J, gs, bits,
        # q_lo, q_scale, q_max
        "bid_launch": [_P] * 11 + [_I, _I, _I, _I, _F, _F, _F, _P],
        # choice, key, d, md, gf, mf, accept, used_g, used_m, ws (two
        # halves of 3N words, kernels.AcceptWorkspace), half, N, J
        "accept_launch": [_P] * 10 + [_I, _I, _I, _P],
    },
    "auction": {
        # benefit, tiebreak, valid, asg, iters, keys (three zeroed u64
        # buffers of N rounded up to even), walked (three int64 counters
        # or null), J, N, max_iters, eps, blocks, smem, vec
        # (kernels.auction_plan)
        "auction_shared_launch": [_P] * 7 + [_I, _I, _I, _F, _I, _I, _I, _P],
        # benefit, tiebreak, valid, asg, iters, ws, walked, J, N,
        # max_iters, eps: the two-barrier kernel
        "auction_launch": [_P] * 7 + [_I, _I, _I, _F, _P],
    },
    "route_pick": {
        "route_pick_launch": [_P] * 5 + [_I, _I, _P],
    },
    "decode_attention": {
        # q, k, v, lengths, out, B, H, n_kv, D, S, scale, dtype
        "decode_attention_launch": [_P] * 5 + [_I] * 5 + [_F, _I, _P],
        # q, k_pool, v_pool, tables, lengths, out, B, T, H, n_kv, D, bs, M,
        # scale, dtype
        "decode_attention_blocks_launch": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
        # q, k_pool, v_pool, k_scales, v_scales, k_tail, v_tail, tables,
        # lengths, out, B, T, H, n_kv, D, bs, M, scale, dtype
        "decode_attention_blocks_q8_launch":
            [_P] * 10 + [_I] * 7 + [_F, _I, _P],
    },
    "decode_split": {
        # q, k, v, lengths, out, ws, tickets, walked (an int counter or
        # null), B, H, n_kv, D, S, C, scale, dtype
        "decode_split_launch": [_P] * 8 + [_I] * 6 + [_F, _I, _P],
        # q, k_pool, v_pool, tables, lengths, out, ws, tickets, walked, B,
        # T, H, n_kv, D, bs, M, C, scale, dtype
        "decode_split_blocks_launch": [_P] * 9 + [_I] * 8 + [_F, _I, _P],
        # q, k_pool, v_pool (int8), k_scales, v_scales, k_tail, v_tail,
        # tables, lengths, out, ws, tickets, walked, B, T, H, n_kv, D, bs,
        # M, C, scale, dtype
        "decode_split_blocks_q8_launch":
            [_P] * 13 + [_I] * 8 + [_F, _I, _P],
    },
    "flash_prefill": {
        # q, k, v, row_lens, out, lse (null for #9), B, T, S, H, n_kv, D,
        # q_offset, scale, dtype
        "flash_prefill_launch": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
        # q, k, v, mask, out, B, T, S, H, n_kv, D, scale, dtype (#9b)
        "flash_masked_launch": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
    },
    "flash_prefill_tc": {
        # q, k, v, row_lens, out, lse (null for #9), B, T, S, H, n_kv, D,
        # q_offset, scale (bf16, D % 64 == 0)
        "flash_prefill_tc_launch": [_P] * 6 + [_I] * 7 + [_F, _P],
        # q, k, v, mask, out, walked (an int counter or null), B, T, S, H,
        # n_kv, D, scale (#9b)
        "flash_masked_tc_launch": [_P] * 6 + [_I] * 6 + [_F, _P],
    },
    "flash_backward": {
        # q, k, v, dO, lse, drow, row_lens, dq, B, T, S, H, n_kv, D,
        # q_offset, scale, dtype
        "flash_bwd_dq_launch": [_P] * 8 + [_I] * 7 + [_F, _I, _P],
        # ... dk, dv, B, T, S, H, n_kv, D, q_offset, scale, dtype
        "flash_bwd_dkv_launch": [_P] * 9 + [_I] * 7 + [_F, _I, _P],
    },
    "flash_backward_tc": {
        # q, k, v, dO, lse, drow, row_lens, dq, walked (an int counter or
        # null), B, T, S, H, n_kv, D, q_offset, scale (bf16, D 64 or 128)
        "flash_bwd_dq_tc_launch": [_P] * 9 + [_I] * 7 + [_F, _P],
        # ... dk, dv, walked, B, T, S, H, n_kv, D, q_offset, scale
        "flash_bwd_dkv_tc_launch": [_P] * 10 + [_I] * 7 + [_F, _P],
    },
    "quant_matmul": {
        # x, qw, scale, out, workspace, M, N, K, splits, dtype
        "quant_matmul_launch": [_P] * 5 + [_I] * 5 + [_P],
    },
    "quant_matmul_tc": {
        # x, qw, scale, out, workspace, tickets, M, N, K, rows, splits,
        # k_per (bf16, K % 16 == 0, N % 16 == 0)
        "quant_matmul_tc_launch": [_P] * 6 + [_I] * 6 + [_P],
    },
}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    if name not in _SIGNATURES:
        raise ValueError(f"unknown kernel library {name!r}")
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, fn).argtypes = argtypes
    err = getattr(lib, f"{name}_error_string")
    err.restype = ctypes.c_char_p
    err.argtypes = [_I]
    lib.error_string = err  # what the wrappers report a failure with
