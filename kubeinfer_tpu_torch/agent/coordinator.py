"""Coordinator role: own the model, serve it, run the inference runtime.

A copy of ``kubeinfer_tpu/agent/coordinator.py`` in the port (its metrics,
tracing and resilience layers are the port's own copies).

Parity: reference internal/agent/coordinator/coordinator.go:13-116 —
``Run``: ensure model present (dir non-empty) → else download from the hub
→ start the model file server → start the runtime → block → stop runtime.

The hub download is a pluggable callable (production default shells out to
``huggingface-cli download <repo> --local-dir <path>`` exactly like
coordinator.go:99-105; tests inject a fabricator). Download duration feeds
the kubeinfer_model_download_duration_seconds{source="hub"} histogram the
reference declared but never recorded (SURVEY.md §2 #10).
"""

from __future__ import annotations

import json
import logging
import pathlib
import subprocess
import threading
import time
from typing import Callable

from kubeinfer_tpu_torch import metrics
from kubeinfer_tpu_torch.agent.model_server import ModelServer, ensure_model_dir
from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig, RuntimeServer

log = logging.getLogger(__name__)


def hub_download(model_repo: str, model_path: str) -> None:
    """coordinator.go:99-105: shell out to huggingface-cli."""
    subprocess.run(
        ["huggingface-cli", "download", model_repo, "--local-dir", model_path],
        check=True,
    )


def mock_download(model_repo: str, model_path: str) -> None:
    """Fabricate a tiny model directory — the no-egress downloader used by
    demos, process-level e2e, and the quickstart (the role the reference's
    vllm-mock image plays for its Kind e2e, test/testdata/vllm-mock)."""
    root = pathlib.Path(model_path)
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_text(
        json.dumps({"model_type": "mock", "repo": model_repo}) + "\n"
    )
    (root / "weights").mkdir(exist_ok=True)
    (root / "weights" / "model-00001.safetensors").write_bytes(
        b"\0" * 4096
    )


class Coordinator:
    """One elected coordinator per cache group."""

    def __init__(
        self,
        model_repo: str,
        model_path: str,
        runtime_config: RuntimeConfig | None = None,
        downloader: Callable[[str, str], None] = hub_download,
        serve_host: str = "127.0.0.1",
        serve_port: int = 0,
        start_runtime: bool = True,
        serve_model: bool = True,
    ) -> None:
        self.model_repo = model_repo
        self.model_path = model_path
        self._downloader = downloader
        self._runtime_config = runtime_config
        self._serve_host = serve_host
        self._serve_port = serve_port
        self._start_runtime = start_runtime
        self._serve_model = serve_model
        self.model_server: ModelServer | None = None
        self.runtime: RuntimeServer | None = None
        self._ready = threading.Event()

    @property
    def endpoint(self) -> str:
        """Model-server URL (valid once running)."""
        return self.model_server.endpoint if self.model_server else ""

    def wait_ready(self, timeout: float | None = None) -> bool:
        return self._ready.wait(timeout)

    def ensure_model(self) -> None:
        """coordinator.go:35,62-80: cached iff dir non-empty."""
        if ensure_model_dir(self.model_path):
            log.info("model cache hit at %s", self.model_path)
            return
        pathlib.Path(self.model_path).mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        self._downloader(self.model_repo, self.model_path)
        metrics.model_download_duration_seconds.observe(
            "hub", time.perf_counter() - t0
        )

    def run_prepare(self, cancel=None) -> None:
        """Setup: model present, server + runtime started and healthy.

        ``cancel`` (threading.Event) aborts the health wait early —
        role teardown must not block for the full health timeout.
        """
        self.ensure_model()
        if self._serve_model:
            self.model_server = ModelServer(
                self.model_path, host=self._serve_host, port=self._serve_port
            )
            self.model_server.start()  # coordinator.go:39-43
        if self._start_runtime:
            self.runtime = RuntimeServer(
                self._runtime_config or RuntimeConfig(model_path=self.model_path)
            )
            self.runtime.start()  # coordinator.go:46-50
            # Ready must mean "serving": the engine may spend tens of
            # seconds importing/compiling before it answers (the
            # reference never waits — its replicas look live while vLLM
            # is still loading weights).
            if not self.runtime.wait_healthy(cancel=cancel):
                raise RuntimeError(
                    "inference runtime did not become healthy (timeout "
                    f"{self.runtime.config.health_timeout_s:.0f}s or role "
                    "torn down)"
                )
        self._ready.set()

    def shutdown(self) -> None:
        if self.runtime is not None:
            self.runtime.stop()  # coordinator.go:53-54
            self.runtime = None
        if self.model_server is not None:
            self.model_server.stop()
            self.model_server = None

