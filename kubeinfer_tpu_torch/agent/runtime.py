"""Inference runtime (vLLM) process lifecycle.

Parity: reference internal/agent/vllm/vllm.go:13-143 — config struct with
env overrides, CLI arg construction, subprocess start/wait/SIGTERM-stop.
Defaults match vllm.go:34-43 (:8000, TP=1, gpu-mem-util 0.9, dtype auto);
env override names keep the VLLM_ prefix so reference deployments port.

The launch command is templated (``command_prefix``) so tests run a mock
server (port of test/testdata/vllm-mock/mock_server.py) and deployments
can swap in the port's own serving entrypoint without touching lifecycle
code. Counterpart of ``kubeinfer_tpu/agent/runtime.py``: the same config,
arguments and lifecycle; ``RUNTIME_KIND=native`` runs the port's server.
"""

from __future__ import annotations

import os
import shlex
import signal
import subprocess
import sys
from dataclasses import dataclass, field


@dataclass
class RuntimeConfig:
    """vllm.go:13-31 Config parity."""

    model_path: str = "/models"
    host: str = "0.0.0.0"
    port: int = 8000
    tensor_parallel_size: int = 1
    gpu_memory_utilization: float = 0.9
    max_model_len: int = 0  # 0 = server default
    dtype: str = "auto"
    extra_args: list[str] = field(default_factory=list)
    # Seconds to wait for the spawned server's /health before the replica
    # is considered Ready (0 disables the wait). Not in the reference —
    # it never tracks runtime readiness at all; without this the replica
    # reports Ready while the engine is still importing/compiling.
    health_timeout_s: float = 180.0
    # Not in the reference: the executable to wrap. Defaults to the vLLM
    # OpenAI server exactly like vllm.go:95; tests override.
    command_prefix: list[str] = field(
        default_factory=lambda: [
            sys.executable, "-m", "vllm.entrypoints.openai.api_server",
        ]
    )

    @classmethod
    def from_env(cls, env: dict[str, str] | None = None) -> "RuntimeConfig":
        """vllm.go:46-80 LoadConfigFromEnv parity (VLLM_* family), plus
        RUNTIME_KIND selecting the engine:

        - ``vllm`` (default): the external vLLM OpenAI server, reference
          behavior;
        - ``native``: the port's PyTorch + CUDA engine
          (kubeinfer_tpu_torch.inference.server — same CLI surface);
        - explicit RUNTIME_COMMAND overrides both.
        """
        e = os.environ if env is None else env
        cfg = cls()
        kind = e.get("RUNTIME_KIND", "vllm")
        if kind == "native":
            cfg.command_prefix = [
                sys.executable, "-m", "kubeinfer_tpu_torch.inference.server",
            ]
        elif kind != "vllm":
            raise ValueError(f"unknown RUNTIME_KIND {kind!r}")
        cfg.model_path = e.get("MODEL_PATH", cfg.model_path)
        cfg.host = e.get("VLLM_HOST", cfg.host)
        cfg.port = int(e.get("VLLM_PORT", cfg.port))
        cfg.tensor_parallel_size = int(
            e.get("VLLM_TENSOR_PARALLEL_SIZE", cfg.tensor_parallel_size)
        )
        cfg.gpu_memory_utilization = float(
            e.get("VLLM_GPU_MEMORY_UTILIZATION", cfg.gpu_memory_utilization)
        )
        cfg.max_model_len = int(e.get("VLLM_MAX_MODEL_LEN", cfg.max_model_len))
        cfg.dtype = e.get("VLLM_DTYPE", cfg.dtype)
        cfg.health_timeout_s = float(
            e.get("VLLM_HEALTH_TIMEOUT_S", cfg.health_timeout_s)
        )
        extra = e.get("VLLM_EXTRA_ARGS", "")
        if extra:
            cfg.extra_args = shlex.split(extra)
        cmd = e.get("RUNTIME_COMMAND", "")
        if cmd:
            cfg.command_prefix = shlex.split(cmd)
        return cfg

    def build_args(self) -> list[str]:
        """vllm.go:93-112 buildArgs parity."""
        args = list(self.command_prefix) + [
            "--model", self.model_path,
            "--host", self.host,
            "--port", str(self.port),
            "--tensor-parallel-size", str(self.tensor_parallel_size),
            "--gpu-memory-utilization", str(self.gpu_memory_utilization),
            "--dtype", self.dtype,
        ]
        if self.max_model_len > 0:
            args += ["--max-model-len", str(self.max_model_len)]
        args += self.extra_args
        return args


class RuntimeServer:
    """vllm.go:115-142 Server parity: Start / Wait / Stop(SIGTERM)."""

    def __init__(self, config: RuntimeConfig):
        self.config = config
        self._proc: subprocess.Popen | None = None

    def start(self) -> None:
        if self._proc is not None:
            raise RuntimeError("runtime already started")
        self._proc = subprocess.Popen(
            self.config.build_args(),
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )

    def pid(self) -> int | None:
        return self._proc.pid if self._proc else None

    def wait_healthy(
        self, timeout_s: float | None = None, cancel=None
    ) -> bool:
        """Poll the spawned server's /health until 200, death, timeout,
        or ``cancel`` (a threading.Event) is set.

        Works for vLLM, the native engine, and the test mock — all serve
        GET /health. Returns False (and the process keeps running) on
        timeout or cancellation; raises if the process already exited.
        The cancel hook matters for role teardown: without it a role
        restart would block behind a (possibly minutes-long) health wait
        while the old runtime still owns the serving port.

        The poll loop IS this edge's retry policy (fixed 0.5s cadence
        under an overall deadline — backoff would only delay readiness);
        the ``runtime.health`` fault point injects probe failures so
        chaos tests can pin the slow-start and flapping-health paths.
        """
        import time
        import urllib.error
        import urllib.request

        from kubeinfer_tpu_torch.resilience import faultpoints

        if timeout_s is None:
            timeout_s = self.config.health_timeout_s
        if timeout_s <= 0:
            return True
        host = self.config.host if self.config.host != "0.0.0.0" else "127.0.0.1"
        url = f"http://{host}:{self.config.port}/health"
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if cancel is not None and cancel.is_set():
                return False
            if self._proc is not None and self._proc.poll() is not None:
                raise RuntimeError(
                    f"runtime exited with code {self._proc.returncode} "
                    "before becoming healthy"
                )
            try:
                # injected faults (error/latency/blackhole) are handled
                # exactly like real probe failures below
                faultpoints.fire("runtime.health", key=url)
                with urllib.request.urlopen(url, timeout=2) as resp:
                    if resp.status == 200:
                        return True
            except (urllib.error.URLError, OSError):
                pass
            if cancel is not None:
                if cancel.wait(0.5):
                    return False
            else:
                time.sleep(0.5)
        return False

    def running(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def wait(self, timeout: float | None = None) -> int:
        if self._proc is None:
            raise RuntimeError("runtime not started")
        return self._proc.wait(timeout=timeout)

    def stop(self, grace_s: float = 10.0) -> None:
        """SIGTERM, escalate to SIGKILL after the grace period
        (vllm.go:137-142 sends SIGTERM only; the kill escalation prevents
        a wedged server from leaking)."""
        if self._proc is None or self._proc.poll() is not None:
            return
        self._proc.send_signal(signal.SIGTERM)
        try:
            self._proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=5.0)
