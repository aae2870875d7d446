"""``python -m kubeinfer_tpu_torch.agent`` — the node-agent binary.

Env-driven configuration, matching the reference agent's contract
(cmd/agent/main.go:38-48 reads POD_NAME/POD_NAMESPACE/CONFIGMAP_NAME/
MODEL_PATH from env; the controller injects them,
llmservice_controller.go:231-266). Our node agent adds the solver-feeding
duties, so its env surface covers node identity and capacity:

  NODE_NAME            node identity (default: hostname)
  STORE_ADDR           control-plane store URL, e.g. http://127.0.0.1:18080
  STORE_TOKEN_FILE     bearer-token file for the store (optional)
  STORE_CA_FILE        CA bundle verifying an https store (optional)
  MODEL_PATH           model cache root (default /models, ref parity)
  GPU_CAPACITY         schedulable chip count (default 8)
  GPU_MEMORY           per-node accelerator memory, e.g. 16Gi (default 16Gi)
  AUTO_DETECT_ACCELERATORS  "1": observe the local CUDA cards (count +
                       memory, torch.cuda) instead of the
                       GPU_CAPACITY/GPU_MEMORY env
                       (explicit env still wins when both are set)
  TOPOLOGY             "rack,island" coordinates (default 0,0)
  HEARTBEAT_INTERVAL_S node-state heartbeat period (default 10)
  START_RUNTIMES       "1" to exec real inference runtimes (default 0)
  KUBEINFER_DOWNLOADER "hub" (huggingface-cli) or "mock" (fabricated
                       weights for demos/e2e without network egress)
  LEASE_DURATION_S / LEASE_RENEW_S / LEASE_RETRY_S
                       election timings override (default 15/10/2,
                       election.go:41-43)

Signal handling mirrors cmd/agent/main.go:85-91: SIGINT/SIGTERM stop the
agent, which surrenders any held leases (clean failover).
"""

from __future__ import annotations

import logging
import os
import signal
import socket
import sys
import threading

from kubeinfer_tpu_torch.agent.coordinator import hub_download, mock_download
from kubeinfer_tpu_torch.agent.node_agent import NodeAgent
from kubeinfer_tpu_torch.api.types import parse_quantity
from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore, load_token


def main() -> int:
    logging.basicConfig(
        level=getattr(logging, os.environ.get("LOG_LEVEL", "info").upper()),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("agent")

    store_addr = os.environ.get("STORE_ADDR", "")
    if not store_addr:
        log.error("STORE_ADDR is required (control-plane store URL)")
        return 2
    token_file = os.environ.get("STORE_TOKEN_FILE", "")
    ca_file = os.environ.get("STORE_CA_FILE", "")
    token = load_token(token_file) if token_file else ""

    node_name = os.environ.get("NODE_NAME", socket.gethostname())
    model_root = os.environ.get("MODEL_PATH", "/models")
    gpu_capacity = float(os.environ.get("GPU_CAPACITY", "8"))
    gpu_memory = parse_quantity(os.environ.get("GPU_MEMORY", "16Gi"))
    observe_memory = None
    if os.environ.get("AUTO_DETECT_ACCELERATORS", "0") == "1":
        from kubeinfer_tpu_torch.agent.probe import probe_accelerators

        def observe_memory():
            i = probe_accelerators()
            # knownness, not truthiness: free == 0 (HBM fully exhausted
            # by an external process) is precisely the signal the solver
            # must see
            if i is None or not i.memory_free_known:
                return None
            return i.memory_bytes, i.memory_free_bytes

        info = probe_accelerators()
        if info is not None:
            log.info(
                "observed %d %s device(s), %.1f GiB HBM",
                info.count, info.platform, info.memory_bytes / 2**30,
            )
            if "GPU_CAPACITY" not in os.environ:
                gpu_capacity = float(info.count)
            if "GPU_MEMORY" not in os.environ and info.memory_bytes:
                gpu_memory = info.memory_bytes
        else:
            log.warning("AUTO_DETECT_ACCELERATORS=1 but no devices observed")
    topo = [int(x) for x in os.environ.get("TOPOLOGY", "0,0").split(",")]
    interval = float(os.environ.get("HEARTBEAT_INTERVAL_S", "10"))
    start_runtimes = os.environ.get("START_RUNTIMES", "0") == "1"
    downloader = (
        mock_download
        if os.environ.get("KUBEINFER_DOWNLOADER", "hub") == "mock"
        else hub_download
    )
    lease_timings = None
    if "LEASE_DURATION_S" in os.environ:
        lease_timings = (
            float(os.environ["LEASE_DURATION_S"]),
            float(os.environ.get("LEASE_RENEW_S", "10")),
            float(os.environ.get("LEASE_RETRY_S", "2")),
        )

    store = RemoteStore(store_addr, token=token, ca_file=ca_file)
    if not store.healthz():
        log.error("store %s is not reachable", store_addr)
        return 1

    agent = NodeAgent(
        store,
        node_name=node_name,
        gpu_capacity=gpu_capacity,
        gpu_memory_bytes=gpu_memory,
        model_root=model_root,
        topology=(topo[0], topo[1] if len(topo) > 1 else 0),
        heartbeat_interval_s=interval,
        downloader=downloader,
        start_runtimes=start_runtimes,
        lease_timings=lease_timings,
        observe_memory=observe_memory,
    )

    stop = threading.Event()

    def on_signal(signum, frame):
        log.info("signal %d: stopping node agent", signum)
        stop.set()

    signal.signal(signal.SIGINT, on_signal)
    signal.signal(signal.SIGTERM, on_signal)

    log.info(
        "node agent %s: %.0f chips, %d bytes accel mem, store %s",
        node_name, gpu_capacity, gpu_memory, store_addr,
    )
    agent.start()
    try:
        while not stop.is_set():
            stop.wait(0.5)
    finally:
        agent.stop()  # surrenders leases → immediate coordinator failover
    return 0


if __name__ == "__main__":
    sys.exit(main())
