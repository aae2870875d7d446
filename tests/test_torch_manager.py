"""The port's manager (``python -m kubeinfer_tpu_torch.manager``) on the CPU.

As ``tests/test_manager.py`` holds the reference's: probes, secured
``/metrics`` and a tick over a CR applied through the wire; leader
failover between two managers sharing one store. Beside those: ``POST
/solve`` on the hosted store answers as the reference's handler does on
the same body, the reference's ``RemoteStore`` drives the port's manager,
and without a card neither the manager nor its binary starts unless the
CPU is asked for. Every server binds port 0.
"""

from __future__ import annotations

import os
import queue
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from kubeinfer_tpu.controlplane.httpstore import RemoteStore as RefRemote
from kubeinfer_tpu.scheduler.backends import (
    solve_service_handler as ref_solve_handler,
)
from kubeinfer_tpu_torch.api.types import LLMService
from kubeinfer_tpu_torch.api.workload import NodeState, Workload
from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore, StoreServer
from kubeinfer_tpu_torch.controlplane.store import NotFoundError, Store
from kubeinfer_tpu_torch.manager import Manager, ManagerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def skip_on_a_card():
    """The refusals below need a machine without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.fixture(autouse=True)
def reference_routes_as_on_its_accelerator(monkeypatch):
    """The port routes a greedy solve as the reference does on its
    accelerator (the mega loop where both bucket axes are 128-aligned and
    a window fits). The reference's own CPU route is the pipelined loop
    everywhere, so its ``auto`` is pointed at the accelerator's choice,
    with the jnp twins standing in for the TPU kernels, and JAX's jit
    caches are dropped around the change (it is read at trace time)."""
    import jax

    from kubeinfer_tpu.solver import core, pallas_kernels as pk

    real = core._resolve_accel

    def on_accelerator(accel, J, N):
        if accel == "auto" and J % 128 == 0 and N % 128 == 0:
            return "mega-jnp" if pk.mega_window(N, J) is not None else "jnp"
        return real(accel, J, N)

    monkeypatch.setattr(core, "_resolve_accel", on_accelerator)
    jax.clear_caches()
    yield
    jax.clear_caches()


def http_get(url: str, token: str = "") -> tuple[int, str]:
    req = urllib.request.Request(url)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""


def ephemeral_config(**over) -> ManagerConfig:
    cfg = ManagerConfig(
        store_bind_port=0, metrics_bind_port=0, health_bind_port=0,
        tick_interval_s=0.1, device="cpu",
    )
    for k, v in over.items():
        setattr(cfg, k, v)
    return cfg


def wait_until(pred, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.05)
    pytest.fail(f"timed out waiting for {what}")


def sample_svc(name: str = "svc", **spec) -> dict:
    return LLMService.from_dict(
        {"metadata": {"name": name},
         "spec": {"model": "org/m", "replicas": 1, **spec}}
    ).to_dict()


def sample_node(name: str, gpu: int = 8) -> dict:
    n = NodeState(gpu_capacity=gpu, gpu_free=gpu,
                  gpu_memory_bytes=64 * 2**30,
                  gpu_memory_free_bytes=64 * 2**30)
    n.metadata.name = name
    return n.to_dict()


def test_probes_metrics_and_reconcile():
    mgr = Manager(ephemeral_config(auth_token="tok")).start()
    try:
        health = f"http://127.0.0.1:{mgr.health_server.port}"
        metrics_url = f"http://127.0.0.1:{mgr.metrics_server.port}/metrics"
        assert http_get(f"{health}/healthz")[0] == 200
        wait_until(lambda: http_get(f"{health}/readyz")[0] == 200, 10,
                   "readyz")
        assert http_get(metrics_url)[0] == 401
        code, body = http_get(metrics_url, token="tok")
        assert code == 200 and "kubeinfer_reconcile_total" in body
        mport = mgr.metrics_server.port
        assert http_get(f"http://127.0.0.1:{mport}/healthz")[0] == 200

        remote = RemoteStore(mgr.store_address, token="tok")
        remote.create(LLMService.KIND, sample_svc())
        wait_until(
            lambda: remote.get(LLMService.KIND, "svc")["status"]["phase"]
            == "Pending", 10, "status synced by controller",
        )
        # a node arrives: the next tick binds the replica to it
        remote.create(NodeState.KIND, sample_node("node-0"))
        remote.create(LLMService.KIND,
                      sample_svc("svc-n", schedulerPolicy="native-greedy"))

        def bound(name):
            try:
                w = remote.get(Workload.KIND, name)
            except NotFoundError:
                return False
            return all(r["node"] == "node-0" for r in w["replicas"])

        wait_until(lambda: bound("svc") and bound("svc-n"), 10,
                   "both replicas bound")
        code, body = http_get(metrics_url, token="tok")
        for policy in ("jax-greedy", "native-greedy"):
            m = re.search(
                r'kubeinfer_solve_duration_seconds_count\{policy="'
                + policy + r'"\} (\d+)', body)
            assert m and int(m.group(1)) >= 1, policy
    finally:
        mgr.stop()


def test_reference_client_drives_the_port_manager():
    """The reference's RemoteStore (the one its ctl and agents use)
    applies a service to the port's manager and reads its status back."""
    mgr = Manager(ephemeral_config(auth_token="tok")).start()
    try:
        remote = RefRemote(mgr.store_address, token="tok")
        remote.create("Node", sample_node("node-0"))
        remote.create("LLMService", sample_svc("svc", replicas=2))
        wait_until(
            lambda: remote.get("LLMService", "svc")["status"]["phase"]
            == "Scheduling", 10, "replicas bound",
        )
        assert remote.get("LLMService", "svc")["status"]["placements"] == [
            "node-0", "node-0"]
    finally:
        mgr.stop()


def test_leader_election_failover():
    backing = Store()
    store_srv = StoreServer(backing, port=0).start()
    try:
        timings = (1.0, 0.5, 0.1)
        mk = lambda ident: Manager(ephemeral_config(  # noqa: E731
            store_connect=store_srv.address, leader_elect=True,
            identity=ident, lease_timings=timings,
        ))
        a = mk("manager-a").start()
        wait_until(lambda: a._is_leader.is_set(), 10, "A leads")
        b = mk("manager-b").start()
        time.sleep(0.5)
        assert not b._is_leader.is_set(), "standby must not lead"
        a.stop()
        wait_until(lambda: b._is_leader.is_set(), 10, "B takeover")
        remote = RemoteStore(store_srv.address)
        remote.create(LLMService.KIND, sample_svc("ha-svc"))
        wait_until(
            lambda: remote.get(LLMService.KIND, "ha-svc")["status"][
                "phase"] == "Pending", 10, "B reconciles",
        )
        lease = backing.get("Lease", "kubeinfer-manager")
        assert lease["spec"]["holderIdentity"] == "manager-b"
        b.stop()
    finally:
        store_srv.shutdown()


def solve_body(J, N, seed):
    """A fractional-GPU body as BASELINE.json config 2 sizes it (1k jobs
    x 128 nodes), with priorities and topology."""
    rng = np.random.default_rng(seed)
    return {
        "policy": "jax-greedy",
        "jobs": {
            "gpu": rng.choice([0.25, 0.5, 1.0, 2.0], J).tolist(),
            "memGib": rng.integers(1, 16, J).astype(float).tolist(),
            "priority": rng.integers(0, 4, J).astype(float).tolist(),
        },
        "nodes": {
            "gpuFree": [8.0] * N,
            "memFreeGib": [128.0] * N,
            "topology": rng.integers(0, 4, N).tolist(),
        },
    }


@pytest.mark.parametrize("J,N,seed", [(1000, 128, 2), (40, 8, 5)],
                         ids=["1k x 128", "40 x 8"])
def test_solve_rpc_matches_reference_handler(J, N, seed):
    body = solve_body(J, N, seed)
    want = ref_solve_handler(body)
    mgr = Manager(ephemeral_config()).start()
    try:
        got = RemoteStore(mgr.store_address)._req("POST", "/solve", body)
    finally:
        mgr.stop()
    for key in ("assignment", "placed", "policy", "rounds"):
        assert got[key] == want[key], key
    assert got["placed"] > 0


def test_manager_without_a_card_refuses_to_start():
    skip_on_a_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Manager(ephemeral_config(device=None))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Manager(ephemeral_config(device="cuda"))


def _manager_cmd(*extra):
    return [sys.executable, "-m", "kubeinfer_tpu_torch.manager",
            "--store-bind-address", "127.0.0.1:0",
            "--metrics-bind-address", "127.0.0.1:0",
            "--health-probe-bind-address", "127.0.0.1:0", *extra]


def test_binary_without_a_card_exits_with_an_error():
    skip_on_a_card()
    out = subprocess.run(_manager_cmd(), cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 1
    assert "CUDA is not available (--device cuda)" in out.stderr


def test_binary_serves_on_the_cpu_and_stops_on_sigterm():
    proc = subprocess.Popen(
        _manager_cmd("--device", "cpu", "--tick-interval", "0.2"),
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True,
    )
    # stderr is read on a thread, so a manager that stays alive without
    # logging cannot hold this test past its deadline (a bare readline()
    # would block for good), and a chatty one never fills the pipe
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stderr:
            lines.put(line)

    pumper = threading.Thread(target=pump, daemon=True)
    pumper.start()
    try:
        health = None
        deadline = time.monotonic() + 60
        while health is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            m = re.search(r"probes on :(\d+)", line)
            if m:
                health = f"http://127.0.0.1:{m.group(1)}"
        assert health, "the manager never reported its probe port"
        wait_until(lambda: http_get(f"{health}/readyz")[0] == 200, 30,
                   "readyz")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        pumper.join(10)  # the pipe is at its end once the process is
        proc.stderr.close()
