"""The serial C++ baseline scorer (``native/``), loaded through ctypes."""

from kubeinfer_tpu_torch.native.lib import (
    NativeLibraryError,
    load_native,
    native_available,
    solve_greedy_native,
)

__all__ = [
    "NativeLibraryError",
    "load_native",
    "native_available",
    "solve_greedy_native",
]
