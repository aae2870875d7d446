"""The slice as a whole: one routed mix in ``bench.py:fleet_routing_bench``'s
shape at tiny size, through the JAX package's ``RouterServer`` over its
tiny servers and through the port's over port tiny servers (the
reference's weights carried across by ``weights.params_from_reference``).

Three replicas, four families of 32-token prefixes (blocks of 16), each
family planted on replica ``f % 3`` by a direct post, then one
``/cache/summary`` poll and eight shuffled requests (a family prefix and
8 tail tokens, 4 new, greedy) sent in two concurrent waves of four with
a 20 ms storm window, so the waves take the batched route solve. Both
fleets give every request the same replica, match depth and tokens.
"""

from __future__ import annotations

import json
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from kubeinfer_tpu.inference import PRESETS as JP
from kubeinfer_tpu.inference import init_params as j_init
from kubeinfer_tpu.inference.batching import ContinuousEngine as JC
from kubeinfer_tpu.inference.engine import Engine as JE
from kubeinfer_tpu.inference.server import InferenceServer as JS
from kubeinfer_tpu.router import FleetRouter as JRouter
from kubeinfer_tpu.router import RouterServer as JRouterServer
from kubeinfer_tpu_torch.inference import weights as tw
from kubeinfer_tpu_torch.inference.batching import ContinuousEngine as TC
from kubeinfer_tpu_torch.inference.config import PRESETS as TP
from kubeinfer_tpu_torch.inference.engine import Engine as TE
from kubeinfer_tpu_torch.inference.server import InferenceServer as TS
from kubeinfer_tpu_torch.router import FleetRouter, RouterServer

JT, TT = JP["tiny"], TP["tiny"]
BS, N_REPLICAS, FAMILIES, PREFIX, TAIL, NEW = 16, 3, 4, 32, 8, 4


@pytest.fixture(scope="module")
def params():
    p = j_init(JT, jax.random.PRNGKey(0))
    return p, tw.params_from_reference(jax.tree.map(np.asarray, p), "cpu")


def mix(seed=17):
    rng = np.random.default_rng(seed)
    prefixes = [rng.integers(0, TT.vocab_size, PREFIX).tolist()
                for _ in range(FAMILIES)]
    order = [f for f in range(FAMILIES) for _ in range(2)]
    rng.shuffle(order)
    requests = [prefixes[f] + rng.integers(0, TT.vocab_size, TAIL).tolist()
                for f in order]
    return prefixes, order, requests


def fleet(pkg, params):
    servers = []
    for i in range(N_REPLICAS):
        if pkg == "jax":
            cont = JC(params[0], JT, n_slots=2, cache_len=128,
                      block_size=BS).start()
            srv = JS(JE(params[0], JT), model_id=f"r{i}", port=0,
                     continuous=cont).start()
        else:
            cont = TC(params[1], TT, n_slots=2, cache_len=128, block_size=BS,
                      device="cpu").start()
            srv = TS(TE(params[1], TT, device="cpu"), model_id=f"r{i}",
                     port=0, continuous=cont, device="cpu").start()
        servers.append((srv, cont))
    router = (JRouter() if pkg == "jax" else FleetRouter(device="cpu"))
    for i, (srv, _) in enumerate(servers):
        router.add_replica(f"r{i}", f"http://127.0.0.1:{srv.port}")
    rs = (JRouterServer if pkg == "jax" else RouterServer)(
        router, storm_window_s=0.02)
    return servers, router, rs


def run_mix(pkg, params):
    prefixes, _, requests = mix()
    servers, router, rs = fleet(pkg, params)
    try:
        for f, prefix in enumerate(prefixes):
            srv = servers[f % N_REPLICAS][0]
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.port}/v1/completions",
                data=json.dumps({"prompt": prefix,
                                 "max_tokens": NEW}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                assert r.status == 200
        assert rs.poll_once() == N_REPLICAS

        def one(prompt):
            code, payload = rs.forward(json.dumps(
                {"prompt": prompt, "max_tokens": NEW}).encode())
            assert code == 200
            doc = json.loads(payload)
            return (doc["kubeinfer"]["replica"],
                    doc["kubeinfer"]["match_blocks"],
                    doc["choices"][0]["tokens"])

        out = []
        with ThreadPoolExecutor(4) as pool:
            for wave in (requests[:4], requests[4:]):
                out += list(pool.map(one, wave))
        return out, router
    finally:
        rs.stop()
        for srv, cont in servers:
            srv.stop()
            cont.stop()


def test_routed_mix_equals_the_reference_fleets(params):
    _, order, _ = mix()
    ours, router = run_mix("port", params)
    ref, _ = run_mix("jax", params)
    assert ours == ref
    # every request lands on its family's planted replica with its whole
    # prefix matched
    assert [(r, m) for r, m, _ in ours] == [
        (f"r{f % N_REPLICAS}", PREFIX // BS) for f in order]
    assert router.affinity_hit_rate == 1.0
    assert router.metrics["solver_routed"].value("parity") == len(order)
