"""The ctypes signatures ``_build`` declares for every kernel launcher
agree with the ``extern "C"`` declarations in the CUDA sources: the same
number of parameters, each a pointer, an int or a float in the same
place. A mismatch would pass the wrong bits to a kernel on the card and
cannot show on the CPU any other way. A build that fails leaves the
build directory as it found it and no nvcc running."""

from __future__ import annotations

import ctypes
import re
import subprocess

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


def _listing(d):
    return sorted(p.name for p in d.iterdir()) if d.exists() else None


def test_build_without_nvcc_leaves_the_build_dir_alone(monkeypatch, tmp_path):
    """No nvcc on PATH or under CUDA_HOME: the call raises before it
    makes a temporary library, so the build directory gains no file."""
    empty = tmp_path / "cuda"
    empty.mkdir()
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(empty))
    stale = sorted(_build._SIGNATURES)
    for build_dir in (_build.BUILD_DIR, tmp_path / "build"):
        monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
        before = _listing(build_dir)
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.build_all(stale)
        assert _listing(build_dir) == before


def test_build_stops_started_nvcc_when_a_later_one_cannot_start(
    monkeypatch, tmp_path
):
    """The second nvcc fails to start: the first is killed and reaped,
    and both temporary libraries are gone."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 60\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    build_dir = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    started = []
    real_popen = subprocess.Popen

    def popen(cmd, **kw):
        if started:
            raise OSError("cannot start another nvcc")
        started.append(real_popen(cmd, **kw))
        return started[-1]

    monkeypatch.setattr(_build.subprocess, "Popen", popen)
    with pytest.raises(OSError, match="cannot start another nvcc"):
        _build.build_all(["route_pick", "auction"])
    assert len(started) == 1
    assert started[0].returncode is not None
    assert _listing(build_dir) == []
