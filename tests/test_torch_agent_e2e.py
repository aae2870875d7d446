"""The port's process-level path on the CPU: ``python -m
kubeinfer_tpu_torch.manager --device cpu``, two ``python -m
kubeinfer_tpu_torch.agent`` processes and ``python -m
kubeinfer_tpu_torch.ctl apply -f`` of a ``runtime: native`` LLMService
with a shared cache.

A ``huggingface-cli`` shim first on the agents' ``PATH`` copies a tiny
checkpoint (the coordinator's real ``hub_download`` runs, with no
network). The service reaches Running with one coordinator and one
follower; the follower's files are byte-equal to the coordinator's; the
two spawned port servers (``--model <node cache dir> --device cpu
--dtype float32``) answer with the reference engine's tokens on the
reference's ``load_pretrained`` of the checkpoint; SIGTERM gives
exit 0 everywhere and the serving ports close. Every wait has its own
deadline and the process tree is killed in a ``finally``.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
TOKEN = "agent-e2e-token"
PROMPT = [3, 1, 4, 1, 5, 9, 2, 6]
SAMPLED = dict(temperature=0.7, top_k=5, seed=4)
SERVICE = """\
apiVersion: ai.kubeinfer-tpu.io/v1
kind: LLMService
metadata:
  name: llm-torch-native
  namespace: default
spec:
  model: org/tiny-llama
  replicas: 2
  gpuPerReplica: 1
  runtime: native
  cacheStrategy: shared
  gpuMemory: 1Gi
  schedulerPolicy: jax-greedy
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_until(pred, timeout_s: float, what: str):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}")


def http(url: str, body: dict | None = None, timeout=60) -> tuple[int, str]:
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, ""
    except OSError:
        return 0, ""


def write_shim(bin_dir: pathlib.Path, mirror: pathlib.Path) -> None:
    """``huggingface-cli download <repo> --local-dir <dir>`` as a copy of
    ``mirror``."""
    bin_dir.mkdir()
    shim = bin_dir / "huggingface-cli"
    shim.write_text(
        f"#!{sys.executable}\n"
        "import shutil, sys\n"
        "a = sys.argv[1:]\n"
        "assert a[0] == 'download', a\n"
        f"shutil.copytree({str(mirror)!r}, a[a.index('--local-dir') + 1], "
        "dirs_exist_ok=True)\n")
    shim.chmod(0o755)


def cache_files(d: pathlib.Path) -> dict[str, bytes]:
    return {str(p.relative_to(d)): p.read_bytes() for p in sorted(d.rglob("*"))
            if p.is_file() and not any(part.startswith(".")
                                       for part in p.relative_to(d).parts)}


def reference_tokens(model_dir: str) -> list[list[int]]:
    """The reference's continuous engine, as the spawned servers build
    theirs for ``--dtype float32``, on its own load of ``model_dir``."""
    import jax.numpy as jnp

    from kubeinfer_tpu.inference.batching import ContinuousEngine
    from kubeinfer_tpu.inference.weights import load_pretrained

    params, cfg = load_pretrained(model_dir, dtype=jnp.float32)
    eng = ContinuousEngine(params, cfg, n_slots=8,
                           cache_len=min(cfg.max_position_embeddings, 4096),
                           prefill_chunk_blocks=4).start()
    try:
        return [eng.generate(PROMPT, 8, **kw) for kw in ({}, SAMPLED)]
    finally:
        eng.stop()


def test_native_service_runs_from_a_shared_checkpoint(tmp_path):
    from kubeinfer_tpu_torch.controlplane.httpstore import RemoteStore
    from tests.conftest import scrubbed_pythonpath
    from tests.test_torch_load import write_checkpoint

    mirror = write_checkpoint(tmp_path / "mirror", "llama", "f32", "model.",
                              seed=7)
    write_shim(tmp_path / "bin", mirror)
    (tmp_path / "token").write_text(TOKEN)
    (tmp_path / "svc.yaml").write_text(SERVICE)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=scrubbed_pythonpath(), HF_HUB_OFFLINE="1")
    env.pop("XLA_FLAGS", None)
    # the reference's tokens, computed on the mirror (the caches are
    # held byte-equal to it below) while the processes start
    want: list = []
    ref = threading.Thread(target=lambda: want.extend(
        reference_tokens(str(mirror))), daemon=True)
    ref.start()
    store_port, metrics_port, health_port = (free_port() for _ in range(3))
    serve_ports = [free_port(), free_port()]
    store_addr = f"http://127.0.0.1:{store_port}"
    procs: list[subprocess.Popen] = []
    try:
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kubeinfer_tpu_torch.manager",
             "--device", "cpu",
             "--store-bind-address", f"127.0.0.1:{store_port}",
             "--metrics-bind-address", f"127.0.0.1:{metrics_port}",
             "--health-probe-bind-address", f"127.0.0.1:{health_port}",
             "--auth-token-file", str(tmp_path / "token"),
             "--tick-interval", "0.2"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL))
        wait_until(lambda: http(f"http://127.0.0.1:{health_port}/readyz")[0]
                   == 200, 60, "manager /readyz")
        for i, port in enumerate(serve_ports):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeinfer_tpu_torch.agent"],
                env=dict(env, NODE_NAME=f"node-{i}", STORE_ADDR=store_addr,
                         STORE_TOKEN_FILE=str(tmp_path / "token"),
                         MODEL_PATH=str(tmp_path / f"models-{i}"),
                         GPU_CAPACITY="1", GPU_MEMORY="16Gi",
                         HEARTBEAT_INTERVAL_S="0.3", START_RUNTIMES="1",
                         LEASE_DURATION_S="2", LEASE_RENEW_S="1",
                         LEASE_RETRY_S="0.2", VLLM_PORT=str(port),
                         VLLM_HOST="127.0.0.1", VLLM_DTYPE="float32",
                         VLLM_EXTRA_ARGS="--device cpu",
                         VLLM_HEALTH_TIMEOUT_S="60",
                         PATH=f"{tmp_path / 'bin'}{os.pathsep}"
                              f"{env.get('PATH', '')}"),
                cwd=REPO, stdout=subprocess.DEVNULL))
        store = RemoteStore(store_addr, token=TOKEN)
        wait_until(lambda: len(store.list("Node")) == 2, 60,
                   "both node heartbeats")
        apply = subprocess.run(
            [sys.executable, "-m", "kubeinfer_tpu_torch.ctl", "--store",
             store_addr, "--token-file", str(tmp_path / "token"), "apply",
             "-f", str(tmp_path / "svc.yaml")],
            env=env, cwd=REPO, capture_output=True, text=True, timeout=60)
        assert apply.returncode == 0, apply.stderr
        assert apply.stdout.strip() == "llmservice/llm-torch-native created"

        def running():
            try:
                svc = store.get("LLMService", "llm-torch-native")
            except (KeyError, OSError):
                return False
            return svc.get("status", {}).get("phase") == "Running"

        wait_until(running, 90, "the service Running")
        w = store.get("Workload", "llm-torch-native")
        assert sorted(r["node"] for r in w["replicas"]) == ["node-0",
                                                             "node-1"]
        assert [r["phase"] for r in w["replicas"]] == ["Ready", "Ready"]
        assert sum(bool(r.get("podIP")) for r in w["replicas"]) == 1
        dirs = [tmp_path / f"models-{i}" / "org--tiny-llama"
                for i in range(2)]
        assert cache_files(dirs[0]) == cache_files(dirs[1]) == \
            cache_files(mirror)
        ref.join(60)
        assert len(want) == 2
        for port in serve_ports:
            for kw, toks in zip(({}, SAMPLED), want):
                code, body = http(f"http://127.0.0.1:{port}/v1/completions",
                                  dict(prompt=PROMPT, max_tokens=8, **kw))
                assert code == 200
                resp = json.loads(body)
                assert resp["choices"][0]["tokens"] == toks
                assert resp["kubeinfer"]["route"] == "continuous"
        for p in reversed(procs):
            p.send_signal(signal.SIGTERM)
        for p in procs:
            assert p.wait(timeout=40) == 0
        procs.clear()
        for port in serve_ports:
            wait_until(lambda: http(f"http://127.0.0.1:{port}/health")[0]
                       == 0, 20, f"serving port {port} closed")
    finally:
        for p in procs:
            p.kill()
            p.wait(timeout=10)


def test_agent_without_a_store_exits_2():
    out = subprocess.run([sys.executable, "-m", "kubeinfer_tpu_torch.agent"],
                         env=dict(os.environ, STORE_ADDR=""), cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 2 and "STORE_ADDR is required" in out.stderr
