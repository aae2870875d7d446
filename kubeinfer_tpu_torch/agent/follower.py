"""Follower role: sync the model from the coordinator, run the runtime.

A copy of ``kubeinfer_tpu/agent/follower.py`` in the port (its metrics,
tracing and resilience layers are the port's own copies).

Parity: reference internal/agent/follower/follower.go:24-150 — ``Run``:
GET coordinator /models list → download each file → start runtime → block.
Transfers are resumable and subdirectory-safe (reference gaps; see
transfer.py). Download duration feeds the
kubeinfer_model_download_duration_seconds{source="coordinator"} histogram —
the intra-cluster number whose ratio to the hub number substantiates the
reference's aspirational "10-100x faster than WAN" claim
(docs/PROJECT_ROADMAP.md:62).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable

from kubeinfer_tpu_torch import metrics
from kubeinfer_tpu_torch.agent.model_server import ensure_model_dir
from kubeinfer_tpu_torch.agent.runtime import RuntimeConfig, RuntimeServer
from kubeinfer_tpu_torch.agent.transfer import (
    TransferError,
    sync_complete,
    sync_model,
)

log = logging.getLogger(__name__)


class Follower:
    """One follower per non-coordinator replica of a cache group."""

    def __init__(
        self,
        coordinator_endpoint: str | Callable[[], str],
        model_path: str,
        runtime_config: RuntimeConfig | None = None,
        start_runtime: bool = True,
        sync_attempts: int = 5,
        transfer_ca_file: str = "",
    ) -> None:
        self._endpoint = coordinator_endpoint
        self.model_path = model_path
        self._runtime_config = runtime_config
        self._start_runtime = start_runtime
        self._sync_attempts = sync_attempts
        # CA bundle for an https coordinator model endpoint (TLS model
        # distribution); empty = plain http endpoints (the default)
        self._transfer_ca = transfer_ca_file
        self.runtime: RuntimeServer | None = None
        self._ready = threading.Event()

    def wait_ready(self, timeout: float | None = None) -> bool:
        return self._ready.wait(timeout)

    def sync(self) -> None:
        """Pull model files from the coordinator (follower.go:52-63).

        Always runs sync_model — even over a warm cache — because a
        checksum pass is the only thing that catches same-size stale
        content after a coordinator failover (sync skips files whose
        checksums match, so the warm-cache case costs one listing plus
        local hashing, no transfers). The download histogram only records
        syncs that actually moved bytes, keeping the WAN-vs-cluster
        comparison (PROJECT_ROADMAP.md:62) honest.
        """
        warm = ensure_model_dir(self.model_path)
        if warm:
            log.info(
                "model cache present at %s; verifying against coordinator",
                self.model_path,
            )
        t0 = time.perf_counter()
        try:
            sync_model(
                self._endpoint, self.model_path,
                attempts=self._sync_attempts, ca_file=self._transfer_ca,
            )
        except TransferError:
            # Availability beats freshness — but ONLY for a provably
            # COMPLETE copy (the sync-complete marker; a non-empty dir
            # alone can be a killed multi-file sync whose every present
            # file is whole): a follower restarting mid-failover serves
            # its verified-at-download-time cache rather than blocking
            # for the whole failover window; the next successful sync
            # re-verifies checksums.
            if not (warm and sync_complete(self.model_path)):
                raise
            log.warning(
                "%s: coordinator unreachable; serving existing complete "
                "local copy unverified", self.model_path,
            )
        if not warm:
            metrics.model_download_duration_seconds.observe(
                "coordinator", time.perf_counter() - t0
            )

    def start_serving(self, cancel=None) -> None:
        """Start the runtime once the model is in place; ``cancel``
        aborts the health wait on role teardown."""
        if self._start_runtime:
            self.runtime = RuntimeServer(
                self._runtime_config or RuntimeConfig(model_path=self.model_path)
            )
            self.runtime.start()  # follower.go:65-69
            if not self.runtime.wait_healthy(cancel=cancel):
                raise RuntimeError(
                    "inference runtime did not become healthy (timeout "
                    f"{self.runtime.config.health_timeout_s:.0f}s or role "
                    "torn down)"
                )
        self._ready.set()

    def shutdown(self) -> None:
        if self.runtime is not None:
            self.runtime.stop()
            self.runtime = None
