"""The port's agent plane (``kubeinfer_tpu_torch.agent``) and ``ctl`` on
the CPU, held against the JAX package's copies.

The cases of ``tests/test_agent_runtime.py``, ``test_node_agent.py`` and
``test_probe.py`` run on the port's modules, and where both packages can
meet they are crossed: the runtime's config and command line equal the
reference's (but for the native module's name); the port's transfer
client pulls from the reference's model server and the reference's from
the port's, with byte-equal listings; a replica agent of each package
makes the same store writes on the same sequence; a heartbeat's
NodeState is the reference's dict, ``serving_stats`` from a port
``ContinuousEngine.stats_summary`` included; the probe reads
``torch.cuda``; ``ctl`` prints what the reference's prints against one
port ``StoreServer``. Real threads and HTTP on localhost, fast lease
timings on a real clock, as the reference's tests run.
"""

from __future__ import annotations

import copy
import hashlib
import http.client
import json
import pathlib
import sys
import threading
import time
import urllib.request

import pytest
import torch

from kubeinfer_tpu import ctl as jctl
from kubeinfer_tpu.agent import node_agent as jna
from kubeinfer_tpu.agent import runtime as jrt
from kubeinfer_tpu.agent import transfer as jtr
from kubeinfer_tpu.agent.model_server import ModelServer as JModelServer
from kubeinfer_tpu.api.workload import ReplicaSpec as JReplica
from kubeinfer_tpu.api.workload import Workload as JWorkload
from kubeinfer_tpu.controlplane import Store as JStore
from kubeinfer_tpu_torch import ctl
from kubeinfer_tpu_torch.agent import (
    ModelServer,
    NodeAgent,
    ReplicaAgent,
    RuntimeConfig,
    RuntimeServer,
)
from kubeinfer_tpu_torch.agent import node_agent as tna
from kubeinfer_tpu_torch.agent import probe
from kubeinfer_tpu_torch.agent.model_server import ensure_model_dir
from kubeinfer_tpu_torch.agent.node_agent import model_cache_dir
from kubeinfer_tpu_torch.agent.transfer import (
    TransferError,
    download_file,
    fetch_file_list,
    sync_model,
)
from kubeinfer_tpu_torch.api.workload import NodeState, ReplicaSpec, Workload
from kubeinfer_tpu_torch.controlplane.httpstore import StoreServer
from kubeinfer_tpu_torch.controlplane.store import Store
from kubeinfer_tpu_torch.resilience import faultpoints

TESTDATA = pathlib.Path(__file__).parent / "testdata"
MOCK_CMD = [sys.executable, str(TESTDATA / "mock_inference_server.py")]
FAST_LEASE = (1.5, 1.0, 0.1)  # duration, renew, retry


# -- runtime.py ---------------------------------------------------------------

ENVS = [
    {},
    {"MODEL_PATH": "/m", "VLLM_PORT": "9000",
     "VLLM_TENSOR_PARALLEL_SIZE": "4", "VLLM_GPU_MEMORY_UTILIZATION": "0.5",
     "VLLM_MAX_MODEL_LEN": "8192", "VLLM_DTYPE": "bfloat16",
     "VLLM_EXTRA_ARGS": "--foo bar", "VLLM_HEALTH_TIMEOUT_S": "7"},
    {"RUNTIME_KIND": "native", "VLLM_HOST": "127.0.0.1",
     "VLLM_EXTRA_ARGS": "--device cpu --weight-dtype int8"},
    {"RUNTIME_KIND": "native", "RUNTIME_COMMAND": "python3 -m x --y 'a b'"},
]


@pytest.mark.parametrize("env", ENVS, ids=["defaults", "vllm-env",
                                           "native", "command"])
def test_runtime_config_matches_reference(env):
    ours, ref = RuntimeConfig.from_env(env), jrt.RuntimeConfig.from_env(env)
    want = ref.build_args()
    if env.get("RUNTIME_KIND") == "native" and "RUNTIME_COMMAND" not in env:
        # the one difference: the native kind runs the port's server
        assert want[:3] == [sys.executable, "-m",
                            "kubeinfer_tpu.inference.server"]
        want[2] = "kubeinfer_tpu_torch.inference.server"
    assert ours.build_args() == want
    assert ours.health_timeout_s == ref.health_timeout_s
    assert "--max-model-len" in want or not env.get("VLLM_MAX_MODEL_LEN")


def test_runtime_defaults_and_unknown_kind():
    cfg = RuntimeConfig()
    assert (cfg.port, cfg.tensor_parallel_size, cfg.gpu_memory_utilization,
            cfg.dtype) == (8000, 1, 0.9, "auto")
    assert "--max-model-len" not in cfg.build_args()
    for mod in (RuntimeConfig, jrt.RuntimeConfig):
        with pytest.raises(ValueError, match="unknown RUNTIME_KIND"):
            mod.from_env({"RUNTIME_KIND": "tgi"})


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_runtime_start_health_stop(tmp_path):
    port = free_port()
    srv = RuntimeServer(RuntimeConfig(
        model_path=str(tmp_path), host="127.0.0.1", port=port,
        command_prefix=MOCK_CMD))
    srv.start()
    try:
        assert srv.wait_healthy(timeout_s=20)
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                    timeout=5) as r:
            assert b"healthy" in r.read()
        assert srv.running() and srv.pid() is not None
        with pytest.raises(RuntimeError, match="already started"):
            srv.start()
    finally:
        srv.stop()
    assert not srv.running()
    RuntimeServer(RuntimeConfig()).stop()  # before start: a no-op


def test_runtime_stop_escalates_to_sigkill():
    """A server that ignores SIGTERM is killed after the grace period."""
    code = ("import signal, time, sys; "
            "signal.signal(signal.SIGTERM, signal.SIG_IGN); "
            "print('up', flush=True); time.sleep(60)")
    srv = RuntimeServer(RuntimeConfig(
        command_prefix=[sys.executable, "-c", code, "--"]))
    srv.start()
    time.sleep(0.5)  # let it install the handler
    t0 = time.monotonic()
    srv.stop(grace_s=0.5)
    assert not srv.running() and srv.wait() == -9
    assert time.monotonic() - t0 < 5


def test_runtime_health_fault_point_and_early_exit(tmp_path):
    """``runtime.health`` faults count as failed probes (the wait times
    out while the server stays up); a server that dies raises."""
    port = free_port()
    srv = RuntimeServer(RuntimeConfig(
        model_path=str(tmp_path), host="127.0.0.1", port=port,
        command_prefix=MOCK_CMD))
    faultpoints.REGISTRY.arm(faultpoints.FaultSpec(
        point="runtime.health", mode="error", kind="refused"))
    srv.start()
    try:
        assert not srv.wait_healthy(timeout_s=1.5)
        assert srv.running()
        faultpoints.REGISTRY.disarm("runtime.health")
        assert srv.wait_healthy(timeout_s=20)
        cancel = threading.Event()
        cancel.set()
        assert not RuntimeServer(srv.config).wait_healthy(5, cancel=cancel)
    finally:
        faultpoints.REGISTRY.disarm("runtime.health")
        srv.stop()
    dead = RuntimeServer(RuntimeConfig(
        command_prefix=[sys.executable, "-c", "raise SystemExit(3)", "--"]))
    dead.start()
    with pytest.raises(RuntimeError, match="code 3"):
        dead.wait_healthy(timeout_s=20)


# -- model_server.py + transfer.py ------------------------------------------

def make_model_dir(root: pathlib.Path) -> None:
    root.mkdir(parents=True, exist_ok=True)
    (root / "config.json").write_bytes(b'{"arch": "test"}')
    (root / "model-00001.safetensors").write_bytes(
        bytes(range(256)) * 1200)
    sub = root / "tokenizer"
    sub.mkdir(exist_ok=True)
    (sub / "vocab.json").write_bytes(b'{"a": 1}')
    (root / ".kubeinfer-sync-complete").write_text("{}")  # never listed
    (root / "half.bin.part").write_bytes(b"x")  # never listed


SERVERS = {"port": ModelServer, "reference": JModelServer}
CLIENTS = {"port": (sync_model, fetch_file_list),
           "reference": (jtr.sync_model, jtr.fetch_file_list)}


@pytest.fixture()
def both_served(tmp_path):
    src = tmp_path / "src"
    make_model_dir(src)
    servers = {k: cls(str(src), port=0) for k, cls in SERVERS.items()}
    for s in servers.values():
        s.start()
    yield servers, src
    for s in servers.values():
        s.stop()


def raw_get(server, path: str) -> tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=5)
    try:
        conn.request("GET", path)  # raw: urllib would normalize the dots
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_listing_and_routes_byte_equal(both_served):
    servers, _ = both_served
    for path in ("/health", "/models", "/models/config.json",
                 "/models/tokenizer/vocab.json", "/models/../../etc/passwd",
                 "/models/.kubeinfer-sync-complete/../config.json",
                 "/models/absent", "/other"):
        got, want = raw_get(servers["port"], path), raw_get(
            servers["reference"], path)
        assert got[0] == want[0], path
        if got[0] == 200:
            assert got[1] == want[1], path
    status, body = raw_get(servers["port"], "/models")
    lines = body.decode().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == [
        "config.json", "model-00001.safetensors", "tokenizer/vocab.json"]
    assert lines[0].split("\t")[2] == hashlib.sha256(
        b'{"arch": "test"}').hexdigest()
    assert raw_get(servers["port"], "/models/../../etc/passwd")[0] == 404


@pytest.mark.parametrize("server,client", [("port", "reference"),
                                           ("reference", "port"),
                                           ("port", "port")])
def test_sync_crosses_packages(both_served, tmp_path, server, client):
    servers, src = both_served
    sync, listing = CLIENTS[client]
    dest = tmp_path / f"dest-{server}-{client}"
    files = sync(servers[server].endpoint, str(dest))
    assert sorted(files) == ["config.json", "model-00001.safetensors",
                             "tokenizer/vocab.json"]
    for f in files:
        assert (dest / f).read_bytes() == (src / f).read_bytes()
    assert ensure_model_dir(str(dest))
    assert (dest / ".kubeinfer-sync-complete").exists()
    assert [(e.path, e.size, e.sha256) for e in listing(
        servers[server].endpoint)] == [
        (e.path, e.size, e.sha256)
        for e in fetch_file_list(servers["reference"].endpoint)]


@pytest.mark.parametrize("server", ["port", "reference"])
def test_range_request_resumes(both_served, tmp_path, server):
    servers, src = both_served
    full = (src / "model-00001.safetensors").read_bytes()
    dest = tmp_path / "dest"
    dest.mkdir()
    (dest / "model-00001.safetensors.part").write_bytes(full[:100_000])
    n = download_file(servers[server].endpoint, "model-00001.safetensors",
                      str(dest))
    assert n == len(full) - 100_000
    assert (dest / "model-00001.safetensors").read_bytes() == full
    n = download_file(servers[server].endpoint, "tokenizer/vocab.json",
                      str(dest))
    assert (dest / "tokenizer" / "vocab.json").read_bytes() == b'{"a": 1}'


def test_coordinator_death_mid_transfer_resumes_on_new_endpoint(tmp_path):
    src = tmp_path / "src"
    make_model_dir(src)
    full = (src / "model-00001.safetensors").read_bytes()
    dest = tmp_path / "dest"
    dest.mkdir()
    (dest / "config.json").write_bytes(b'{"arch": "test"}')
    (dest / "model-00001.safetensors.part").write_bytes(full[:120_000])
    dying = ModelServer(str(src), port=0)
    dying.start()
    dying.stop()
    successor = JModelServer(str(src), port=0)  # the reference's, even
    successor.start()
    endpoints = iter([dying.endpoint, successor.endpoint,
                      successor.endpoint])
    try:
        files = sync_model(lambda: next(endpoints), str(dest), attempts=3,
                           retry_delay_s=0.01)
        assert len(files) == 3
        assert (dest / "model-00001.safetensors").read_bytes() == full
    finally:
        successor.stop()


def test_same_size_drift_and_corruption_refetched(tmp_path):
    src = tmp_path / "src"
    make_model_dir(src)
    dest = tmp_path / "dest"
    first = ModelServer(str(src), port=0)
    first.start()
    try:
        sync_model(first.endpoint, str(dest))
        good = (dest / "tokenizer" / "vocab.json").read_bytes()
        (dest / "tokenizer" / "vocab.json").write_bytes(b"X" * len(good))
        sync_model(first.endpoint, str(dest))
        assert (dest / "tokenizer" / "vocab.json").read_bytes() == good
    finally:
        first.stop()
    (src / "config.json").write_bytes(b'{"arch": "live"}')  # same size
    second = ModelServer(str(src), port=0)
    second.start()
    try:
        sync_model(second.endpoint, str(dest))
        assert (dest / "config.json").read_bytes() == b'{"arch": "live"}'
    finally:
        second.stop()


def test_sync_fails_after_attempts_exhausted(tmp_path):
    calls = []
    with pytest.raises(TransferError, match="after 2 attempts"):
        sync_model("http://127.0.0.1:1/", str(tmp_path / "dest"),
                   attempts=2, retry_delay_s=0.01,
                   sleep=lambda s: calls.append(s))
    assert len(calls) == 1
    with pytest.raises(TransferError, match="no coordinator endpoint"):
        sync_model(lambda: "", str(tmp_path / "dest"), attempts=1)


# -- node_agent.py ------------------------------------------------------------

def fab_downloader(calls=None):
    def download(repo: str, path: str) -> None:
        if calls is not None:
            calls.append(repo)
        p = pathlib.Path(path)
        p.mkdir(parents=True, exist_ok=True)
        (p / "config.json").write_bytes(b'{"model": "%s"}' % repo.encode())
        (p / "weights.bin").write_bytes(b"\x01" * 100_000)
        (p / "tokenizer").mkdir(exist_ok=True)
        (p / "tokenizer" / "vocab.json").write_bytes(b"{}")

    return download


def mk_workload(store, name="svc", replicas=2, nodes=("node-a", "node-b"),
                shared=True, ref=False):
    W, R = (JWorkload, JReplica) if ref else (Workload, ReplicaSpec)
    w = W(owner=name, image="img", model_repo=f"org/{name}",
          cache_group=f"{name}-cache", cache_shared=shared,
          gpu_per_replica=1, gpu_memory_bytes=16 << 30,
          replicas=[R(index=i, node=nodes[i % len(nodes)], phase="Starting")
                    for i in range(replicas)])
    w.metadata.name = name
    store.create(W.KIND, w.to_dict())
    return w


def wait_until(pred, timeout=30.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def phases(store, name="svc"):
    return [r["phase"] for r in store.get("Workload", name)["replicas"]]


def replica_agents(store, tmp_path, downloader, nodes=("node-a", "node-b"),
                   cls=ReplicaAgent):
    agents = [cls(store, "svc", "default", i, node,
                  model_root=str(tmp_path / node), downloader=downloader,
                  lease_timings=FAST_LEASE)
              for i, node in enumerate(nodes)]
    for a in agents:
        a.start()
    return agents


def test_two_agents_elect_and_distribute(tmp_path):
    store, calls = Store(), []
    mk_workload(store)
    agents = replica_agents(store, tmp_path, fab_downloader(calls))
    try:
        assert wait_until(lambda: phases(store) == ["Ready", "Ready"])
        assert len(calls) == 1  # one hub download; the follower synced
        w = Workload.from_dict(store.get(Workload.KIND, "svc"))
        coord = [r for r in w.replicas if r.pod_ip]
        assert len(coord) == 1 and coord[0].pod_ip.startswith("http://")
        nodes = ["node-a", "node-b"]
        dirs = [pathlib.Path(model_cache_dir(str(tmp_path / n), "org/svc"))
                for n in nodes]
        for f in ("config.json", "weights.bin", "tokenizer/vocab.json"):
            assert (dirs[0] / f).read_bytes() == (dirs[1] / f).read_bytes()
    finally:
        for a in agents:
            a.stop()


def test_coordinator_failover_promotes_follower(tmp_path):
    store = Store()
    mk_workload(store)
    agents = replica_agents(store, tmp_path, fab_downloader())
    try:
        assert wait_until(lambda: phases(store) == ["Ready", "Ready"])
        w = Workload.from_dict(store.get(Workload.KIND, "svc"))
        idx = next(r.index for r in w.replicas if r.pod_ip)
        agents[idx].stop()
        other = w.replicas[1 - idx].pod_name
        assert wait_until(lambda: store.get("Lease", "svc-cache-lease")[
            "spec"]["holderIdentity"] == other)
    finally:
        for a in agents:
            a.stop()


def test_cache_none_and_shared_node_dir(tmp_path):
    store, calls = Store(), []
    mk_workload(store, shared=False)
    agents = replica_agents(store, tmp_path, fab_downloader(calls))
    try:
        assert wait_until(lambda: phases(store) == ["Ready", "Ready"])
        assert len(calls) == 2  # no shared cache: both hit the hub
        with pytest.raises(KeyError):
            store.get("Lease", "svc-cache-lease")
    finally:
        for a in agents:
            a.stop()
    store, calls = Store(), []
    mk_workload(store, nodes=("node-a",))
    agents = replica_agents(store, tmp_path / "one", fab_downloader(calls),
                            nodes=("node-a", "node-a"))
    try:
        assert wait_until(lambda: phases(store) == ["Ready", "Ready"])
        assert len(calls) == 1  # the second replica found the dir cached
    finally:
        for a in agents:
            a.stop()


def test_torn_down_role_does_not_patch_stale_ready(tmp_path):
    store = Store()
    mk_workload(store, replicas=1, nodes=("node-a",), shared=False)
    release, fab = threading.Event(), fab_downloader()

    def gated(repo, path):
        release.wait(timeout=30)
        fab(repo, path)

    agent = ReplicaAgent(store, "svc", "default", 0, "node-a",
                         model_root=str(tmp_path), downloader=gated,
                         lease_timings=FAST_LEASE)
    agent.start()
    role = agent._role_thread
    agent._role_stop.set()
    release.set()
    role.join(timeout=30)
    assert not role.is_alive() and phases(store) == ["Starting"]
    agent.stop()


class WriteLog:
    """A store wrapper recording each Workload write as its replicas'
    (index, phase, pod_ip set, pod_name)."""

    def __init__(self, store):
        self._store, self.writes = store, []

    def __getattr__(self, name):
        return getattr(self._store, name)

    def update(self, kind, obj):
        if kind == "Workload":
            self.writes.append([(r["index"], r["phase"], bool(r.get("podIP")),
                                 r.get("podName", ""))
                                for r in obj["replicas"]])
        return self._store.update(kind, obj)


@pytest.mark.parametrize("scenario", ["solo", "coordinator", "failed"])
def test_store_writes_match_reference(tmp_path, scenario):
    """One replica through each role, once per package: the same
    Workload writes in the same order."""
    def broken(repo, path):
        raise OSError("hub unreachable")

    logs = []
    for ref in (False, True):
        store = WriteLog(JStore() if ref else Store())
        mk_workload(store, replicas=1, nodes=("node-a",),
                    shared=scenario != "solo", ref=ref)
        cls = jna.ReplicaAgent if ref else ReplicaAgent
        agent = cls(store, "svc", "default", 0, "node-a",
                    model_root=str(tmp_path / str(ref)),
                    downloader=broken if scenario == "failed"
                    else fab_downloader(), lease_timings=FAST_LEASE)
        agent.start()
        want = "Failed" if scenario == "failed" else "Ready"
        try:
            assert wait_until(lambda: phases(store) == [want])
        finally:
            agent.stop()
        logs.append(store.writes)
    assert logs[0] == logs[1] and logs[0][-1][0][1] == want


def node_agent(store, tmp_path, name="node-a", **kw):
    return NodeAgent(store, name, gpu_capacity=8, gpu_memory_bytes=64 << 30,
                     model_root=str(tmp_path), downloader=fab_downloader(),
                     lease_timings=FAST_LEASE, **kw)


@pytest.mark.parametrize("change", ["model", "image", "env"])
def test_spawns_reaps_and_restarts_replica_agents(tmp_path, change):
    store = Store()
    mk_workload(store)
    na = node_agent(store, tmp_path)
    try:
        na.tick()
        assert len(na._agents) == 1  # only replica 0 is on node-a
        first = na._agents[("default", "svc", 0)]
        assert wait_until(lambda: phases(store)[0] == "Ready")
        w = Workload.from_dict(store.get(Workload.KIND, "svc"))
        if change == "model":
            w.model_repo = "org/other"
        elif change == "image":
            w.image = "img:v2"
        else:
            w.env = {**w.env, "RUNTIME_KIND": "native"}
        w.replicas[0].phase = "Starting"  # what the reconciler does
        store.update(Workload.KIND, w.to_dict())
        na.tick()
        second = na._agents[("default", "svc", 0)]
        assert second is not first
        assert wait_until(lambda: phases(store)[0] == "Ready")
        w = Workload.from_dict(store.get(Workload.KIND, "svc"))
        w.replicas[0].node = "node-b"  # rebound elsewhere: reaped
        store.update(Workload.KIND, w.to_dict())
        na.tick()
        assert not na._agents
    finally:
        na.stop()


class FixedClock:
    def __init__(self, t=1234.5):
        self.t = t

    def now(self):
        return self.t

    def wait(self, event, timeout):
        return event.wait(timeout)


def stats_summary():
    """A port ContinuousEngine's stats_summary after one request."""
    from kubeinfer_tpu_torch.inference.batching import ContinuousEngine
    from kubeinfer_tpu_torch.inference.config import PRESETS
    from kubeinfer_tpu_torch.inference.model import init_params

    cfg = PRESETS["tiny"]
    eng = ContinuousEngine(init_params(cfg, seed=0, device="cpu"), cfg,
                           n_slots=2, cache_len=64, block_size=16,
                           device="cpu").start()
    try:
        eng.generate(list(range(3, 40)), 4)
        return eng.stats_summary()
    finally:
        eng.stop()


@pytest.mark.parametrize("observe", [None, (64 << 30, 44 << 30)],
                         ids=["configured", "observed"])
def test_heartbeat_matches_reference(tmp_path, observe):
    summary = stats_summary()
    states = []
    for ref in (False, True):
        store = JStore() if ref else Store()
        root = tmp_path / str(ref)
        fab_downloader()("org/cached", model_cache_dir(str(root),
                                                       "org/cached"))
        w = mk_workload(store, name="own", replicas=1, nodes=("node-a",),
                        ref=ref)
        cls = jna.NodeAgent if ref else NodeAgent
        na = cls(store, "node-a", gpu_capacity=8,
                 gpu_memory_bytes=64 << 30, model_root=str(root),
                 topology=(1, 2), clock=FixedClock(),
                 downloader=fab_downloader(),
                 observe_memory=(lambda: observe) if observe else None,
                 serving_stats=lambda: copy.deepcopy(summary))
        na._replica_mem[("default", "own", 0)] = w.gpu_memory_bytes
        na.heartbeat()
        d = store.get("Node", "node-a")
        d["metadata"].pop("resourceVersion", None)
        d["metadata"].pop("creationTimestamp", None)
        states.append(d)
    assert states[0] == states[1]
    st = NodeState.from_dict(states[0])
    assert st.cached_models == ["org/cached"] and st.gpu_free == 8
    assert st.serving_stats == summary
    if observe:  # 20 GiB used, 16 of it this node's own replica
        assert st.gpu_memory_free_bytes == 60 << 30


def test_serving_stats_clamp_matches_reference():
    budget = tna.SUMMARY_FINGERPRINT_BUDGET
    big = {"cache_summary": {"fingerprints": list(range(budget + 40)),
                             "block_size": 16}, "qps": 3}
    got = tna._clamp_serving_stats(big)
    assert got == jna._clamp_serving_stats(big)
    assert len(got["cache_summary"]["fingerprints"]) == budget
    assert got["cache_summary"]["truncated"] is True
    assert len(big["cache_summary"]["fingerprints"]) == budget + 40
    small = {"cache_summary": {"fingerprints": [1, 2]}}
    assert tna._clamp_serving_stats(small) is small


def test_degraded_tick_keeps_replicas_and_recovers(tmp_path):
    from kubeinfer_tpu_torch.metrics import agent_store_stale_seconds

    class Flaky:
        def __init__(self, store):
            self._store, self.down = store, False

        def __getattr__(self, name):
            fn = getattr(self._store, name)
            if name in ("list", "get", "update", "create") and self.down:
                def fail(*a, **k):
                    raise ConnectionResetError("store down")
                return fail
            return fn

    store = Flaky(Store())
    mk_workload(store._store, replicas=1, nodes=("node-a",))
    clock = FixedClock(100.0)
    na = node_agent(store, tmp_path, clock=clock)
    try:
        na.tick()
        assert len(na._agents) == 1
        store.down = True
        clock.t = 105.0
        na.tick()  # degraded: the replica keeps running
        assert len(na._agents) == 1
        clock.t = 112.0
        na.tick()
        assert agent_store_stale_seconds.value("node-a") == 7.0
        store.down = False
        na.tick()
        assert agent_store_stale_seconds.value("node-a") == 0.0
    finally:
        na.stop()


# -- probe.py -----------------------------------------------------------------

def test_probe_none_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert probe.probe_accelerators() is None


def test_probe_reads_torch_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (60 << 30, 80 << 30))
    info = probe.probe_accelerators()
    assert info == probe.AcceleratorInfo(
        count=1, platform="gpu", memory_bytes=80 << 30,
        memory_free_bytes=60 << 30, memory_free_known=True)

    def broken(i):
        raise RuntimeError("cuda init")

    monkeypatch.setattr(torch.cuda, "mem_get_info", broken)
    assert probe.probe_accelerators() is None


def test_probe_host_memory():
    total, avail = probe.probe_host_memory()
    assert total > 0 and 0 < avail <= total


# -- ctl.py -------------------------------------------------------------------

SVC = """
apiVersion: ai.kubeinfer-tpu.io/v1
kind: LLMService
metadata:
  name: cli-svc
spec:
  model: org/model
  replicas: 2
  cacheStrategy: shared
"""


def ctl_session(main, tmp_path, capsys) -> list:
    """The same commands against a fresh port StoreServer; returns each
    command's (rc, stdout, stderr) with volatile metadata dropped."""
    server = StoreServer(Store(), port=0).start()
    addr = server.address
    f1, f2 = tmp_path / "a.yaml", tmp_path / "b.yaml"
    f1.write_text(SVC + "---" + SVC.replace("cli-svc", "cli-svc-2"))
    f2.write_text(SVC.replace("replicas: 2", "replicas: 5"))
    bad = tmp_path / "c.yaml"
    bad.write_text(SVC.replace("org/model", '""'))
    out = []
    try:
        for argv in (["apply", "-f", str(f1)], ["apply", "-f", str(f2)],
                     ["apply", "-f", str(bad)], ["get", "llmservices"],
                     ["get", "llmservice", "cli-svc", "-o", "json"],
                     ["get", "llmsvc", "cli-svc", "-o", "yaml"],
                     ["get", "nodes"], ["delete", "llmservice", "cli-svc"],
                     ["get", "llmservice", "cli-svc"],
                     ["delete", "llmservice", "cli-svc"]):
            rc = main(["--store", addr, *argv])
            o, e = capsys.readouterr()
            if "json" in argv:
                d = json.loads(o)
                for k in ("resourceVersion", "creationTimestamp", "uid"):
                    d["metadata"].pop(k, None)
                o = d
            elif "yaml" in argv:
                o = "\n".join(ln for ln in o.splitlines()
                              if "resourceVersion" not in ln
                              and "creationTimestamp" not in ln
                              and "uid:" not in ln)
            out.append((rc, o, e))
        with pytest.raises(SystemExit):
            main(["--store", addr, "get", "frobnicators"])
        out.append(capsys.readouterr())
    finally:
        server.shutdown()
    return out


def test_ctl_matches_reference(tmp_path, capsys):
    ours = ctl_session(ctl.main, tmp_path, capsys)
    theirs = ctl_session(jctl.main, tmp_path, capsys)
    assert ours == theirs
    assert ours[0][0] == 0 and ours[0][1].count("created") == 2
    assert "configured" in ours[1][1]
    assert ours[2][0] == 1 and "spec.model is required" in ours[2][2]
    assert ours[4][1]["spec"]["replicas"] == 5
    assert ours[8][0] == 1
