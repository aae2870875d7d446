"""The port's store, API objects and HTTP store against the reference's.

- The same script of creates, gets, updates, deletes, lists and watches
  gives the same answers, errors and events on both ``Store``s.
- ``from_dict``/``to_dict`` of every API object gives the reference's
  dict, and validation refuses the same inputs with the same message.
- A data directory written by either ``Store`` opens in the other with
  the same objects and resourceVersions, and the two write the same
  bytes for the same mutations (journal and snapshot).
- Either package's ``RemoteStore`` speaks to either package's
  ``StoreServer`` with the same results.
"""

from __future__ import annotations

import threading
import types

import pytest

import kubeinfer_tpu.api.types as ref_types
import kubeinfer_tpu.api.workload as ref_workload
import kubeinfer_tpu.controlplane.httpstore as ref_http
import kubeinfer_tpu.controlplane.store as ref_store
import kubeinfer_tpu_torch.api.types as port_types
import kubeinfer_tpu_torch.api.workload as port_workload
import kubeinfer_tpu_torch.controlplane.httpstore as port_http
import kubeinfer_tpu_torch.controlplane.store as port_store

REF = types.SimpleNamespace(types=ref_types, workload=ref_workload,
                            store=ref_store, http=ref_http)
PORT = types.SimpleNamespace(types=port_types, workload=port_workload,
                             store=port_store, http=port_http)
SIDES = {"ref": REF, "port": PORT}


def obj(name, ns="default", **extra):
    d = {"metadata": {"name": name, "namespace": ns}}
    d.update(extra)
    return d


def _outcome(fn, *args):
    """What a store call gave: its value, or its error's class name."""
    try:
        return ("ok", fn(*args))
    except (KeyError, ValueError, RuntimeError) as e:
        return ("error", type(e).__name__)


def crud_script(store) -> list:
    """A fixed sequence of store calls; every answer goes in the log."""
    log = []
    w = store.watch(kind="Widget")
    log.append(_outcome(store.create, "Widget", obj("a", spec={"x": 1})))
    log.append(_outcome(store.create, "Widget", obj("a")))  # exists
    log.append(_outcome(store.create, "Widget", obj("b", ns="other")))
    log.append(_outcome(store.create, "Gadget", obj("a")))
    log.append(_outcome(store.create, "Widget", {"metadata": {}}))
    log.append(_outcome(store.get, "Widget", "a"))
    log.append(_outcome(store.get, "Widget", "zz"))
    cur = store.get("Widget", "a")
    cur["spec"]["x"] = 2
    log.append(_outcome(store.update, "Widget", cur))
    log.append(_outcome(store.update, "Widget", cur))  # stale rv
    log.append(_outcome(store.update, "Widget", obj("missing")))
    no_ns = store.get("Widget", "a")
    del no_ns["metadata"]["namespace"]
    log.append(_outcome(store.update, "Widget", no_ns))
    log.append(_outcome(store.list, "Widget"))
    log.append(_outcome(store.list, "Widget", "other"))
    log.append(_outcome(store.delete, "Widget", "b", "other"))
    log.append(_outcome(store.delete, "Widget", "b", "other"))
    log.append(_outcome(store.list, "Gadget"))
    events = []
    for _ in range(100):
        events.extend(w.drain())
        if len(events) >= 4:
            break
        threading.Event().wait(0.02)
    w.close()
    log.append([(e.type, e.kind, e.namespace, e.name, e.object,
                 e.resource_version) for e in events])
    log.append(store.dump())
    return log


def test_crud_conflicts_and_watch_match_reference():
    assert crud_script(PORT.store.Store()) == crud_script(REF.store.Store())


def test_retry_on_conflict_matches_reference():
    def run(mod):
        s = mod.Store()
        s.create("Widget", obj("a", spec={"n": 0}))
        seen = []

        def bump():
            d = s.get("Widget", "a")
            seen.append(d["metadata"]["resourceVersion"])
            if len(seen) == 1:  # a racing writer wins the first try
                other = s.get("Widget", "a")
                other["spec"]["n"] += 10
                s.update("Widget", other)
            d["spec"]["n"] += 1
            return s.update("Widget", d)

        out = mod.retry_on_conflict(bump)
        return seen, out, s.dump()

    assert run(PORT.store) == run(REF.store)


# --- API objects ---------------------------------------------------------

SERVICES = [
    {"metadata": {"name": "svc"}, "spec": {"model": "org/m"}},
    {"metadata": {"name": "full", "namespace": "ns1", "uid": "u1",
                  "labels": {"a": "b"}},
     "spec": {"model": "org/m", "replicas": 3, "gpuPerReplica": 2,
              "cacheStrategy": "shared", "image": "img:1",
              "gpuMemory": "40Gi", "schedulerPolicy": "jax-auction",
              "priority": 7, "gang": True, "maxModelLen": 4096,
              "runtime": "native"},
     "status": {"availableReplicas": 1, "phase": "Degraded",
                "cacheCoordinator": "p0", "placements": ["n0", ""],
                "conditions": [{"type": "Available", "status": "False",
                                "reason": "Degraded", "message": "1/2",
                                "lastUpdateTime": 12.5}]}},
]
BAD_SERVICES = [
    {"metadata": {"name": "svc"}, "spec": {}},
    {"metadata": {"name": "svc"}, "spec": {"model": "m", "replicas": 0}},
    {"metadata": {"name": "svc"}, "spec": {"model": "m", "gpuMemory": "4G"}},
    {"metadata": {"name": "svc"},
     "spec": {"model": "m", "schedulerPolicy": "fastest"}},
    {"metadata": {"name": "svc"}, "spec": {"model": "m", "runtime": "x"}},
    {"metadata": {"name": "svc"},
     "spec": {"model": "m", "cacheStrategy": "all"}},
]


@pytest.mark.parametrize("body", SERVICES, ids=["minimal", "full"])
def test_llmservice_dicts_match_reference(body):
    got = PORT.types.LLMService.from_dict(body)
    want = REF.types.LLMService.from_dict(body)
    got.validate()
    want.validate()
    assert got.to_dict() == want.to_dict()
    assert got.spec.gpu_memory_bytes() == want.spec.gpu_memory_bytes()


def _refusal(mod, body):
    try:
        mod.types.LLMService.from_dict(body).validate()
    except mod.types.ValidationError as e:
        return str(e)
    return None


@pytest.mark.parametrize("body", BAD_SERVICES,
                         ids=[f"bad{i}" for i in range(len(BAD_SERVICES))])
def test_validation_refuses_as_the_reference(body):
    want = _refusal(REF, body)
    assert want is not None
    assert _refusal(PORT, body) == want


@pytest.mark.parametrize("q", ["1Gi", "512Mi", "0Gi", "12", "", "3Ti", "x"])
def test_parse_quantity_matches_reference(q):
    def run(mod):
        try:
            return mod.types.parse_quantity(q)
        except mod.types.ValidationError as e:
            return str(e)

    assert run(PORT) == run(REF)


WORKLOAD = {
    "metadata": {"name": "w", "namespace": "ns", "resourceVersion": 4,
                 "ownerReferences": [{"kind": "LLMService", "name": "w"}]},
    "owner": "w", "image": "img", "modelRepo": "org/m",
    "modelPath": "/models", "cacheGroup": "w-cache", "cacheShared": True,
    "gpuPerReplica": 2, "gpuMemoryBytes": 2**34, "env": {"A": "1"},
    "replicas": [{"index": 0, "node": "n0", "phase": "Ready",
                  "podName": "p", "podIp": "10.0.0.1"},
                 {"index": 1}],
}
NODE = {
    "metadata": {"name": "n0"}, "gpuCapacity": 8, "gpuFree": 6,
    "gpuMemoryBytes": 2**36, "gpuMemoryFreeBytes": 2**35,
    "topology": [3, 1, 9], "cachedModels": ["org/m"], "ip": "10.0.0.2",
    "ready": False, "heartbeat": 17.25,
    "servingStats": {"queue_depth": 3, "n_slots": 8},
}


@pytest.mark.parametrize("kind,body", [("Workload", WORKLOAD),
                                       ("NodeState", NODE),
                                       ("Workload", {"metadata": {}}),
                                       ("NodeState", {"metadata": {}})],
                         ids=["workload", "node", "workload-empty",
                              "node-empty"])
def test_workload_and_node_dicts_match_reference(kind, body):
    got = getattr(PORT.workload, kind).from_dict(body).to_dict()
    want = getattr(REF.workload, kind).from_dict(body).to_dict()
    assert got == want


# --- data directories ----------------------------------------------------


def mutate(store, n=23):
    for i in range(n):
        store.create("Node", obj(f"n{i}", spec={"i": i}))
    for i in range(0, n, 3):
        cur = store.get("Node", f"n{i}")
        cur["spec"]["i"] = -i
        store.update("Node", cur)
    store.delete("Node", "n1")
    store.create("Lease", obj("l0", spec={"holderIdentity": "p0"}))


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
@pytest.mark.parametrize("every", [512, 10], ids=["journal", "snapshot"])
def test_data_dir_opens_in_the_other_store(tmp_path, monkeypatch, writer,
                                           reader, every):
    for side in SIDES.values():
        monkeypatch.setattr(side.store, "SNAPSHOT_EVERY", every)
    w = SIDES[writer].store.Store(data_dir=tmp_path)
    mutate(w)
    want = w.dump()
    w.close()
    assert (tmp_path / "snapshot.json").exists() == (every == 10)
    r = SIDES[reader].store.Store(data_dir=tmp_path)
    assert sorted(map(str, r.dump()[1])) == sorted(map(str, want[1]))
    assert r.dump()[0] == want[0]
    # CAS continuity across the switch: the next write's rv follows on
    cur = r.get("Node", "n2")
    assert r.update("Node", cur)["metadata"]["resourceVersion"] == want[0] + 1
    r.close()


@pytest.mark.parametrize("every", [512, 10], ids=["journal", "snapshot"])
def test_the_two_stores_write_the_same_bytes(tmp_path, monkeypatch, every):
    files = {}
    for name, side in SIDES.items():
        monkeypatch.setattr(side.store, "SNAPSHOT_EVERY", every)
        d = tmp_path / name
        s = side.store.Store(data_dir=d)
        mutate(s)
        s.close()
        files[name] = {p.name: p.read_bytes() for p in sorted(d.iterdir())}
    assert files["port"] == files["ref"]
    assert "journal.jsonl" in files["port"]


def test_torn_journal_from_the_reference_reopens_in_the_port(tmp_path):
    s = REF.store.Store(data_dir=tmp_path)
    s.create("Lease", obj("a"))
    s.close()
    with open(tmp_path / "journal.jsonl", "a", encoding="utf-8") as f:
        f.write('{"op":"create","kind":"Lease","ns":"default","na')
    r = PORT.store.Store(data_dir=tmp_path)
    assert [o["metadata"]["name"] for o in r.list("Lease")] == ["a"]
    r.create("Lease", obj("b"))
    r.close()
    assert len(REF.store.Store(data_dir=tmp_path).list("Lease")) == 2


# --- the wire --------------------------------------------------------------


def http_script(remote, mod) -> list:
    log = []
    w = remote.watch(kind="Widget")
    log.append(_outcome(remote.create, "Widget", obj("a", spec={"x": 1})))
    log.append(_outcome(remote.create, "Widget", obj("a")))
    cur = remote.get("Widget", "a")
    cur["spec"]["x"] = 2
    log.append(_outcome(remote.update, "Widget", cur))
    log.append(_outcome(remote.update, "Widget", cur))
    log.append(_outcome(remote.get, "Widget", "nope"))
    log.append(_outcome(remote.list, "Widget"))
    log.append(_outcome(remote.delete, "Widget", "a"))
    bad = {"metadata": {"name": "s"}, "spec": {"replicas": 2}}
    try:
        remote.create("LLMService", bad)
        log.append("admitted")
    except mod.types.ValidationError as e:
        log.append(("refused", str(e)))
    good = {"metadata": {"name": "s"}, "spec": {"model": "org/m"}}
    log.append(_outcome(remote.create, "LLMService", good))
    events = []
    for _ in range(100):
        events.extend(w.drain())
        if len(events) >= 3:
            break
        threading.Event().wait(0.02)
    w.close()
    log.append([(e.type, e.name, e.resource_version) for e in events])
    log.append(remote.dump())
    return log


@pytest.mark.parametrize("server", ["ref", "port"])
@pytest.mark.parametrize("client", ["ref", "port"])
def test_either_client_speaks_to_either_server(server, client):
    def run(srv_side, cli_side):
        store = srv_side.store.Store()
        srv = srv_side.http.StoreServer(store, port=0, token="tok").start()
        try:
            remote = cli_side.http.RemoteStore(srv.address, token="tok")
            return http_script(remote, cli_side)
        finally:
            srv.shutdown()

    assert run(SIDES[server], SIDES[client]) == run(REF, REF)
