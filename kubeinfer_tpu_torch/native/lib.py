"""ctypes loader + numpy wrapper for the native serial scorer.

A copy of ``kubeinfer_tpu/native/lib.py`` (the port imports nothing from
the JAX package): it loads the same library, built from the repo's
``native/`` sources, which gives the port its serial baseline.

Build contract: ``make -C native`` at the repo root produces
``native/libkubeinfer_native.so``. The loader auto-builds once (g++ is part
of the supported toolchain) and raises ``NativeLibraryError`` with the exact
failing command if the library can't be produced or its ABI tag mismatches.
"""

from __future__ import annotations

import ctypes
import pathlib
import subprocess
import threading

import numpy as np

ABI_VERSION = 1

_NATIVE_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libkubeinfer_native.so"

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeLibraryError(RuntimeError):
    """The native library is missing/unbuildable or ABI-incompatible."""


def _build() -> None:
    try:
        proc = subprocess.run(
            ["make", "-C", str(_NATIVE_DIR)], capture_output=True, text=True
        )
    except FileNotFoundError as e:  # no make on PATH
        raise NativeLibraryError(f"building native library failed: {e}") from e
    if proc.returncode != 0:
        raise NativeLibraryError(
            f"building native library failed: `make -C {_NATIVE_DIR}` "
            f"exited {proc.returncode}\nstdout: {proc.stdout}\nstderr: {proc.stderr}"
        )


def _stale() -> bool:
    if not _LIB_PATH.exists():
        return True
    lib_mtime = _LIB_PATH.stat().st_mtime
    return any(
        src.stat().st_mtime > lib_mtime for src in _NATIVE_DIR.glob("*.cpp")
    )


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the native library. Thread-safe, cached."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        # Rebuild BEFORE the first dlopen: once a .so is mapped, relinking it
        # in place and re-dlopening the same path returns the cached stale
        # handle — only a fresh process would see the rebuild.
        if _stale():
            # the once-per-process build must serialize: two racing
            # builders would link a torn .so
            _build()
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError as e:
            raise NativeLibraryError(f"loading {_LIB_PATH} failed: {e}") from e

        lib.ki_abi_version.restype = ctypes.c_int
        got = lib.ki_abi_version()
        if got != ABI_VERSION:
            raise NativeLibraryError(
                f"native ABI version {got} != expected {ABI_VERSION}; "
                f"run `make -C {_NATIVE_DIR} clean all` and restart"
            )

        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.ki_solve_greedy.restype = ctypes.c_int
        lib.ki_solve_greedy.argtypes = [
            ctypes.c_int, ctypes.c_int,
            f32p, f32p, f32p, i32p, i32p, i32p,
            f32p, f32p, f32p, f32p, i32p, u8p, ctypes.c_int,
            f32p, i32p,
        ]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        load_native()
        return True
    except NativeLibraryError:
        return False


def solve_greedy_native(
    *,
    job_gpu: np.ndarray,
    job_mem_gib: np.ndarray,
    job_priority: np.ndarray | None = None,
    job_gang: np.ndarray | None = None,
    job_model: np.ndarray | None = None,
    job_current_node: np.ndarray | None = None,
    node_gpu_free: np.ndarray,
    node_mem_free_gib: np.ndarray,
    node_gpu_capacity: np.ndarray | None = None,
    node_mem_capacity_gib: np.ndarray | None = None,
    node_topology: np.ndarray | None = None,
    node_cached: np.ndarray | None = None,  # bool/uint8 [N, M]
    weights: tuple[float, float, float, float, float] = (1.0, 0.5, 5.0, 8.0, 2.0),
) -> tuple[np.ndarray, int]:
    """Run the serial scorer. Returns (assignment i32[J] with -1 unplaced,
    placed count). Input conventions match
    kubeinfer_tpu_torch.solver.problem.pack_problem_arrays.
    """
    lib = load_native()
    J = int(job_gpu.shape[0])
    N = int(node_gpu_free.shape[0])

    # Length validation up front: the C side only null-checks, so a short
    # array would be an out-of-bounds read, not a Python exception.
    for label, arr, want in (
        ("job_mem_gib", job_mem_gib, J),
        ("job_priority", job_priority, J),
        ("job_gang", job_gang, J),
        ("job_model", job_model, J),
        ("job_current_node", job_current_node, J),
        ("node_mem_free_gib", node_mem_free_gib, N),
        ("node_gpu_capacity", node_gpu_capacity, N),
        ("node_mem_capacity_gib", node_mem_capacity_gib, N),
        ("node_topology", node_topology, N),
    ):
        if arr is not None and arr.shape != (want,):
            raise ValueError(f"{label} shape {arr.shape} != ({want},)")
    if node_cached is not None and (
        node_cached.ndim != 2 or node_cached.shape[0] != N
    ):
        raise ValueError(
            f"node_cached shape {node_cached.shape} != ({N}, num_models)"
        )
    if len(weights) != 5:
        raise ValueError(f"weights must have 5 elements, got {len(weights)}")

    def f32(a, default=None):
        if a is None:
            a = default
        return np.ascontiguousarray(a, np.float32)

    def i32(a, default=None):
        if a is None:
            a = default
        return np.ascontiguousarray(a, np.int32)

    jg = f32(job_gpu)
    jm = f32(job_mem_gib)
    jp = f32(job_priority, np.zeros(J))
    jgang = i32(job_gang, np.full(J, -1))
    jmodel = i32(job_model, np.zeros(J))
    jcur = i32(job_current_node, np.full(J, -1))
    ngf = f32(node_gpu_free)
    nmf = f32(node_mem_free_gib)
    ngc = f32(node_gpu_capacity, ngf)
    nmc = f32(node_mem_capacity_gib, nmf)
    ntopo = i32(node_topology, np.zeros(N))
    if node_cached is None:
        cached = np.zeros((N, 1), np.uint8)
    else:
        cached = np.ascontiguousarray(node_cached, np.uint8)
    max_models = int(cached.shape[1])
    w = np.asarray(weights, np.float32)
    out = np.empty(J, np.int32)

    placed = lib.ki_solve_greedy(
        J, N, jg, jm, jp, jgang, jmodel, jcur,
        ngf, nmf, ngc, nmc, ntopo, cached, max_models, w, out,
    )
    if placed < 0:
        raise NativeLibraryError("ki_solve_greedy rejected its arguments")
    return out, int(placed)
