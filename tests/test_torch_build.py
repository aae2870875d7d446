"""The ctypes signatures ``_build`` declares for every kernel launcher
agree with the ``extern "C"`` declarations in the CUDA sources: the same
number of parameters, each a pointer, an int or a float in the same
place. A mismatch would pass the wrong bits to a kernel on the card and
cannot show on the CPU any other way."""

from __future__ import annotations

import ctypes
import re

import pytest

from kubeinfer_tpu_torch import _build

LAUNCHERS = sorted((lib, fn) for lib, fns in _build._SIGNATURES.items()
                   for fn in fns)


def _c_params(lib: str, fn: str) -> list:
    text = _build.source(lib).read_text()
    found = re.search(r'extern\s+"C"\s+int\s+' + fn + r"\s*\(([^)]*)\)",
                      text)
    assert found, f"{fn} is not declared extern \"C\" in {lib}.cu"
    kinds = []
    for param in found.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            kinds.append(ctypes.c_void_p)
        elif re.match(r"(const )?int \w+$", param):
            kinds.append(ctypes.c_int)
        elif re.match(r"(const )?float \w+$", param):
            kinds.append(ctypes.c_float)
        else:
            raise AssertionError(f"{fn}: unexpected parameter {param!r}")
    return kinds


@pytest.mark.parametrize("lib,fn", LAUNCHERS,
                         ids=[f"{lib}.{fn}" for lib, fn in LAUNCHERS])
def test_launcher_signature_matches_source(lib, fn):
    assert _c_params(lib, fn) == _build._SIGNATURES[lib][fn]


def test_every_source_is_declared():
    """Each CUDA source has a signature table, and its error string
    launcher exists."""
    sources = sorted(p.stem for d in _build.CSRC_DIRS for p in d.glob("*.cu"))
    assert sources == sorted(_build._SIGNATURES)
    for lib in sources:
        text = _build.source(lib).read_text()
        assert re.search(r'extern\s+"C"\s+const\s+char\s*\*\s*' + lib
                         + r"_error_string\s*\(", text), lib
