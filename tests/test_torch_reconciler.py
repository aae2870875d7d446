"""The port's reconcile tick against the reference's, on the CPU.

Every case of ``tests/test_reconciler.py`` (lifecycle, placement, status,
cross-policy capacity, evacuation) plus a few wider ones runs twice: once
through the reference's ``Controller`` (JAX on the CPU) and its store,
types and metrics, once through the port's ``Controller(device="cpu")``
and its copies of them. Both start from the same store contents on a
``SimulatedClock``. After every tick the two must agree exactly on the
whole store (every binding, phase, status and resourceVersion) and on
``ReconcileResult`` (its times excluded: ``solve_ms`` is compared by its
keys), and at the end on every metric value (the duration histograms by
their counts).
"""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

import kubeinfer_tpu.api.types as ref_types
import kubeinfer_tpu.api.workload as ref_workload
import kubeinfer_tpu.controller as ref_controller
import kubeinfer_tpu.controlplane as ref_controlplane
import kubeinfer_tpu.metrics as ref_metrics
import kubeinfer_tpu.utils.clock as ref_clock
import kubeinfer_tpu_torch.api.types as port_types
import kubeinfer_tpu_torch.api.workload as port_workload
import kubeinfer_tpu_torch.controller as port_controller
import kubeinfer_tpu_torch.controlplane as port_controlplane
import kubeinfer_tpu_torch.metrics as port_metrics
import kubeinfer_tpu_torch.utils.clock as port_clock


def _side(types_mod, workload_mod, controller_mod, cp_mod, metrics_mod,
          clock_mod, **controller_kw):
    return types.SimpleNamespace(
        LLMService=types_mod.LLMService,
        LLMServiceSpec=types_mod.LLMServiceSpec,
        SchedulerPolicy=types_mod.SchedulerPolicy,
        NodeState=workload_mod.NodeState,
        Workload=workload_mod.Workload,
        Store=cp_mod.Store,
        Controller=controller_mod.Controller,
        SimulatedClock=clock_mod.SimulatedClock,
        metrics=metrics_mod,
        controller_kw=controller_kw,
    )


REF = _side(ref_types, ref_workload, ref_controller, ref_controlplane,
            ref_metrics, ref_clock)
PORT = _side(port_types, port_workload, port_controller, port_controlplane,
             port_metrics, port_clock, device="cpu")


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


class Run:
    """One side's run of a case: its store, clock and a log of what each
    tick left behind."""

    def __init__(self, s, n_nodes=3, **node_kw):
        self.s = s
        self.store = s.Store()
        self.clock = s.SimulatedClock(start=100.0)
        self.log: list = []
        for i in range(n_nodes):
            self.add_node(f"node-{i}", **node_kw)

    def controller(self, **kw):
        return self.s.Controller(self.store, clock=self.clock,
                                 **self.s.controller_kw, **kw)

    def add_node(self, name, gpu=8, mem_gib=64, cached=(), heartbeat=0.0,
                 serving=None, topology=0):
        n = self.s.NodeState(
            gpu_capacity=gpu,
            gpu_free=gpu,
            gpu_memory_bytes=int(mem_gib * 2**30),
            gpu_memory_free_bytes=int(mem_gib * 2**30),
            cached_models=list(cached),
            heartbeat=heartbeat,
            serving_stats=dict(serving or {}),
            topology=(topology, 0),
        )
        n.metadata.name = name
        self.store.create(self.s.NodeState.KIND, n.to_dict())

    def add_service(self, name="svc", replicas=2, gpu=1, policy="jax-greedy",
                    model=None, **spec_over):
        svc = self.s.LLMService()
        svc.metadata.name = name
        svc.spec = self.s.LLMServiceSpec(
            model=model or f"org/{name}-model",
            replicas=replicas,
            gpu_per_replica=gpu,
            scheduler_policy=self.s.SchedulerPolicy(policy),
            **spec_over,
        )
        svc.validate()
        self.store.create(self.s.LLMService.KIND, svc.to_dict())

    def edit(self, kind, name, fn):
        d = self.store.get(kind, name)
        fn(d)
        self.store.update(kind, d)

    def edit_spec(self, name, **spec):
        self.edit(self.s.LLMService.KIND, name,
                  lambda d: d["spec"].update(spec))

    def set_phases(self, name, phase, indices=None):
        def fn(d):
            for i, r in enumerate(d["replicas"]):
                if indices is None or i in indices:
                    r["phase"] = phase
        self.edit(self.s.Workload.KIND, name, fn)

    def set_serving(self, name, serving):
        self.edit(self.s.NodeState.KIND, name,
                  lambda d: d.__setitem__("servingStats", dict(serving)))

    def tick(self, c):
        res = c.reconcile_once()
        fields = dataclasses.asdict(res)
        fields.pop("duration_ms")
        fields["solve_ms"] = sorted(fields["solve_ms"])
        self.log.append(("tick", fields, self.store.dump()))
        return res

    def record(self, what):
        self.log.append(("note", what))

    def metric_values(self) -> list[str]:
        """Every sample line of the registry; the duration histograms by
        their counts only (their buckets and sums are times)."""
        keep = []
        for line in self.s.metrics.REGISTRY.render().splitlines():
            name = line.split("{")[0].split(" ")[0]
            if name.endswith(("_duration_seconds_bucket",
                              "_duration_seconds_sum")):
                continue
            keep.append(line)
        return keep


# --- the cases of tests/test_reconciler.py --------------------------------


def creates_workload(s):
    r = Run(s)
    r.add_service("svc")
    r.tick(r.controller())
    return r


def scale_up_and_down(s):
    r = Run(s)
    c = r.controller()
    r.add_service("svc", replicas=2)
    r.tick(c)
    r.edit_spec("svc", replicas=5)
    r.tick(c)
    r.edit_spec("svc", replicas=1)
    r.tick(c)
    return r


def model_change_restarts(s):
    r = Run(s)
    c = r.controller()
    r.add_service("svc")
    r.tick(c)
    r.set_phases("svc", "Ready")
    r.edit_spec("svc", model="org/new-model")
    r.tick(c)
    return r


def deleted_service_gc(s):
    r = Run(s)
    c = r.controller()
    r.add_service("svc")
    r.tick(c)
    r.store.delete(s.LLMService.KIND, "svc")
    r.tick(c)
    return r


def workload_recreated(s):
    r = Run(s)
    c = r.controller()
    r.add_service("svc")
    r.tick(c)
    r.store.delete(s.Workload.KIND, "svc")
    r.tick(c)
    return r


def all_bound(s):
    r = Run(s, n_nodes=2)
    r.add_service("svc", replicas=4)
    r.tick(r.controller())
    return r


def no_nodes(s):
    r = Run(s, n_nodes=0)
    r.add_service("svc")
    r.tick(r.controller())
    return r


def stale_node(s):
    r = Run(s, n_nodes=0)
    r.add_node("fresh", heartbeat=95.0)
    r.add_node("stale", heartbeat=10.0)
    r.add_service("svc", replicas=2)
    r.tick(r.controller())
    return r


def queue_pressure(s):
    r = Run(s, n_nodes=0)
    model = "org/svc-model"
    r.add_node("node-hot", cached=(model,), heartbeat=95.0,
               serving={"queue_depth": 8, "n_slots": 2})
    r.add_node("node-idle", cached=(model,), heartbeat=95.0,
               serving={"queue_depth": 0, "n_slots": 2})
    r.add_service("svc", replicas=1)
    r.tick(r.controller())
    return r


def capacity_across_services(s):
    r = Run(s, n_nodes=1, gpu=4)
    r.add_service("a", replicas=3, gpu=2)
    r.add_service("b", replicas=3, gpu=2)
    r.tick(r.controller())
    return r


def priority_preempts(s):
    r = Run(s, n_nodes=1, gpu=2)
    c = r.controller()
    r.add_service("low", replicas=1, gpu=2, priority=0)
    r.tick(c)
    r.add_service("high", replicas=1, gpu=2, priority=10)
    r.tick(c)
    return r


def hysteresis(s):
    r = Run(s, n_nodes=4)
    c = r.controller()
    r.add_service("svc", replicas=4)
    for _ in range(4):
        r.tick(c)
    return r


def gang_all_or_nothing(s):
    r = Run(s, n_nodes=1, gpu=4)
    r.add_service("gang", replicas=3, gpu=2, gang=True)
    r.tick(r.controller())
    return r


def native_policy(s):
    r = Run(s, n_nodes=2)
    r.add_service("svc", replicas=3, policy="native-greedy")
    r.tick(r.controller())
    return r


def status_phases(s):
    r = Run(s)
    c = r.controller()
    r.add_service("svc", replicas=2)
    r.tick(c)
    r.set_phases("svc", "Ready", indices={0})
    r.tick(c)
    r.set_phases("svc", "Ready")
    r.tick(c)
    return r


def cache_coordinator(s):
    r = Run(s)
    r.add_service("svc")
    r.store.create("Lease", {"metadata": {"name": "svc-cache-lease"},
                             "spec": {"holderIdentity": "svc-pod-1"}})
    r.tick(r.controller())
    return r


def no_double_booking(s):
    r = Run(s, n_nodes=1, gpu=8)
    r.add_service("a", replicas=2, gpu=3, policy="jax-greedy")
    r.add_service("b", replicas=2, gpu=3, policy="native-greedy")
    r.tick(r.controller())
    return r


def high_priority_group_first(s):
    r = Run(s, n_nodes=1, gpu=4)
    r.add_service("low", replicas=1, gpu=4, policy="jax-greedy", priority=0)
    r.add_service("high", replicas=1, gpu=4, policy="native-greedy",
                  priority=50)
    r.tick(r.controller())
    return r


def _recording(r):
    def drain(n):
        r.record(("drain", n.metadata.name))
        return True
    return drain


def burning_drained_once(s):
    r = Run(s, n_nodes=2)
    c = r.controller(slo_burn_limit=1.0, drainer=_recording(r))
    r.set_serving("node-0", {"slo_burn": 2.5})
    for _ in range(4):
        r.tick(c)
    return r


def burn_episode_clears(s):
    r = Run(s, n_nodes=1)
    c = r.controller(slo_burn_limit=1.0, drainer=_recording(r))
    for burn in (2.0, 0.1, 3.0):
        r.set_serving("node-0", {"slo_burn": burn})
        r.tick(c)
    return r


def failed_drain_retried(s):
    r = Run(s, n_nodes=1)

    def flaky(n):
        r.record(("drain", n.metadata.name))
        if sum(1 for e in r.log if e[0] == "note") == 1:
            raise RuntimeError("serving plane unreachable")
        return True

    c = r.controller(slo_burn_limit=1.0, drainer=flaky)
    r.set_serving("node-0", {"slo_burn": 2.0})
    r.tick(c)
    r.tick(c)
    return r


def draining_node_skipped(s):
    r = Run(s, n_nodes=1)
    c = r.controller(slo_burn_limit=1.0, drainer=_recording(r))
    r.set_serving("node-0", {"slo_burn": 9.0, "draining": True})
    r.tick(c)
    return r


def evacuation_disabled(s):
    r = Run(s, n_nodes=1)
    r.set_serving("node-0", {"slo_burn": 9.0})
    r.tick(r.controller(drainer=_recording(r)))
    r.tick(r.controller(slo_burn_limit=1.0))
    return r


# --- wider cases ------------------------------------------------------------


def auction_whole_node(s):
    """A jax-auction group of whole-node replicas beside a greedy one:
    the auction group (higher priority) solves first."""
    r = Run(s, n_nodes=6, gpu=8, mem_gib=64)
    c = r.controller()
    r.add_service("big", replicas=4, gpu=8, policy="jax-auction",
                  priority=8, gpu_memory="60Gi")
    r.add_service("small", replicas=5, gpu=2, policy="jax-greedy")
    r.tick(c)
    r.tick(c)
    return r


def auction_fallback(s):
    """jax-auction on a problem that is not whole-node falls back to the
    greedy solve and counts it on kubeinfer_auction_fallback_total."""
    r = Run(s, n_nodes=3, gpu=8)
    r.add_service("svc", replicas=4, gpu=2, policy="jax-auction")
    r.tick(r.controller())
    return r


def seeded_cluster(s):
    """A seeded cluster: 24 nodes over 4 topology domains, some caching
    models and reporting queue depths, 30 services over three policies
    with gangs and priorities. Then churn: a node goes stale, agents
    mark replicas Ready, a service scales, another is deleted."""
    rng = np.random.default_rng(16)
    models = [f"org/m{i}" for i in range(6)]
    r = Run(s, n_nodes=0)
    for i in range(24):
        cached = tuple(m for m in models if rng.random() < 0.3)
        r.add_node(
            f"node-{i:02d}", gpu=int(rng.choice([4, 8])),
            mem_gib=int(rng.choice([64, 128])), cached=cached,
            heartbeat=99.0, topology=i % 4,
            serving={"queue_depth": int(rng.integers(0, 12)),
                     "n_slots": int(rng.choice([2, 4, 8]))},
        )
    for i in range(30):
        policy = str(rng.choice(["jax-greedy", "jax-greedy",
                                 "native-greedy"]))
        r.add_service(
            f"svc-{i:02d}", replicas=int(rng.integers(1, 5)),
            gpu=int(rng.integers(1, 4)), policy=policy,
            model=models[int(rng.integers(0, len(models)))],
            priority=int(rng.integers(0, 4)),
            gang=bool(rng.random() < 0.25),
            gpu_memory=f"{int(rng.integers(4, 24))}Gi",
        )
    c = r.controller(node_ttl_s=30.0)
    r.tick(c)
    r.tick(c)
    r.edit(s.NodeState.KIND, "node-03",
           lambda d: d.__setitem__("heartbeat", 10.0))
    r.set_phases("svc-01", "Ready")
    r.edit_spec("svc-05", replicas=6)
    r.store.delete(s.LLMService.KIND, "svc-07")
    r.tick(c)
    r.clock.advance(5.0)
    r.tick(c)
    return r


def aligned_cluster(s):
    """128 nodes and 256 replica rows: both bucket axes 128-aligned, so
    the greedy group runs the mega loop (#1's route on the card), beside
    a whole-node jax-auction group (#7's) that solves first."""
    rng = np.random.default_rng(7)
    r = Run(s, n_nodes=0)
    for i in range(128):
        r.add_node(f"node-{i:03d}", gpu=8, mem_gib=128,
                   cached=("org/m1",) if i % 9 == 0 else (),
                   heartbeat=99.0, topology=i % 8,
                   serving={"queue_depth": int(rng.integers(0, 9)),
                            "n_slots": 8})
    r.add_service("whole", replicas=16, gpu=8, policy="jax-auction",
                  priority=8, gpu_memory="100Gi")
    for i in range(60):
        r.add_service(f"svc-{i:02d}", replicas=4,
                      gpu=int(rng.integers(1, 5)),
                      model=f"org/m{int(rng.integers(0, 3))}",
                      priority=int(rng.integers(0, 4)),
                      gang=bool(i % 4 == 0),
                      gpu_memory=f"{int(rng.integers(4, 40))}Gi")
    c = r.controller()
    r.tick(c)
    r.edit_spec("svc-03", replicas=8)
    r.tick(c)
    return r


CASES = [
    creates_workload, scale_up_and_down, model_change_restarts,
    deleted_service_gc, workload_recreated, all_bound, no_nodes, stale_node,
    queue_pressure, capacity_across_services, priority_preempts, hysteresis,
    gang_all_or_nothing, native_policy, status_phases, cache_coordinator,
    no_double_booking, high_priority_group_first, burning_drained_once,
    burn_episode_clears, failed_drain_retried, draining_node_skipped,
    evacuation_disabled, auction_whole_node, auction_fallback, seeded_cluster,
    aligned_cluster,
]


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_tick_matches_reference(case):
    REF.metrics.REGISTRY.reset()
    PORT.metrics.REGISTRY.reset()
    ref, port = case(REF), case(PORT)
    assert len(port.log) == len(ref.log)
    for i, (got, want) in enumerate(zip(port.log, ref.log)):
        assert got == want, f"{case.__name__}: entry {i} differs"
    assert port.metric_values() == ref.metric_values()
    assert any(e[0] == "tick" for e in ref.log)


def test_seeded_cluster_places_and_moves():
    """The wide case is not vacuous: it places most replicas, and its
    churn moves or unbinds some of them."""
    REF.metrics.REGISTRY.reset()
    PORT.metrics.REGISTRY.reset()
    run = seeded_cluster(PORT)
    ticks = [e for e in run.log if e[0] == "tick"]
    first = ticks[0][1]
    assert first["replicas_placed"] >= first["replicas_total"] // 2
    assert sorted(first["solve_ms"]) == ["jax-greedy", "native-greedy"]

    def bindings(dump):
        return {(o[2], i): rep["node"] for o in dump[1] if o[0] == "Workload"
                for i, rep in enumerate(o[3]["replicas"])}

    before, after = bindings(ticks[1][2]), bindings(ticks[2][2])
    assert any(before.get(k) != v for k, v in after.items())


def test_controller_without_a_card_raises():
    """device=None means the CUDA card, for every policy: with none the
    port's Controller refuses to be built, even over a store whose only
    services ask for the host's native-greedy solve."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    run = Run(PORT, n_nodes=1)
    run.add_service("svc", policy="native-greedy")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_controller.Controller(run.store)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_controller.Controller(run.store, device="cuda")


def test_aligned_cluster_reaches_the_tick_kernels(monkeypatch):
    """The tick reaches its three kernels through their wrappers: the
    mega loop (#1) for the greedy group, the auction (#7) for the
    whole-node group and the route pick (#8) in every group's
    solved_affinity. On the CPU each wrapper runs its plain version."""
    from kubeinfer_tpu_torch.solver import kernels

    calls = {"mega_solve": 0, "auction_solve": 0, "route_pick": 0}
    for name in calls:
        real = getattr(kernels, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(kernels, name, counted)
    aligned_cluster(PORT)
    assert all(n > 0 for n in calls.values()), calls
