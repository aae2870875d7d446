"""Builds and loads the port's CUDA kernels.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into the git-ignored
``build/`` directory beside this file, and loaded with ctypes; every
pointer and the stream cross as ``c_void_p``. A failed build raises: there
is no fallback. Nothing here runs at import time.
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
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

# -fmad=false: the plain PyTorch version rounds every multiply and add on
# its own, so the kernel must not fuse them (the source uses __fmul_rn /
# __fadd_rn on its bid arithmetic as well, which nvcc never contracts).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

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


def build(name: str) -> tuple[pathlib.Path, str]:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.
    Returns the library's path and nvcc's report (empty when cached)."""
    return build_all([name])[name]


def build_all(names: list[str]) -> dict[str, tuple[pathlib.Path, str]]:
    """``build`` for several sources, with one nvcc per stale source, all
    started together."""
    done, running = {}, {}
    for name in names:
        src = CSRC / f"{name}.cu"
        out = BUILD_DIR / f"lib{name}.so"
        if out.exists() and out.stat().st_mtime >= src.stat().st_mtime:
            done[name] = (out, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # compile to a private name and rename: a concurrent build never
        # sees (or loads) a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(src)]
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
        "mega_solve_launch": [_P] * 18 + [_I, _I, _I, _I, _F, _F, _F, _I, _P],
    },
    "round_ops": {
        "fence_launch": [_P] * 6 + [_I, _I, _P],
        "bid_launch": [_P] * 11 + [_I, _I, _I, _I, _F, _F, _F, _P],
        "accept_launch": [_P] * 11 + [_I, _I, _P],
    },
    "auction": {
        "auction_launch": [_P] * 6 + [_I, _I, _I, _F, _P],
    },
    "route_pick": {
        "route_pick_launch": [_P] * 5 + [_I, _I, _P],
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
    lib.error_string = err  # what kernels._launch reports a failure with
