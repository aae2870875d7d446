"""The fleet router's batched route solve on the card (no JAX here):

    python -m pytest tests/test_torch_router_card.py -m cuda -q

At ``bench.py:fleet_storm_bench``'s plant cut to 20 replicas and 512
requests, ``route_batch`` on ``FleetRouter(device="cuda")`` (kernel #8,
``solver/csrc/route_pick.cu``) gives the decisions of
``device="cpu"`` (the plain ``route_pick``) in all three modes, and the
same counters. Skips without a card.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

import chip_smoke
from kubeinfer_tpu_torch.router import FleetRouter
from kubeinfer_tpu_torch.solver import kernels
from kubeinfer_tpu_torch.utils.clock import SimulatedClock


def storm(device):
    """``chip_smoke.fleet_plant`` cut to 20 replicas and 512 requests."""
    r = FleetRouter(clock=SimulatedClock(start=1000.0).now, device=device)
    requests, *_ = chip_smoke.fleet_plant(r, n_requests=512, n_replicas=20)
    return r, requests


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["parity", "greedy", "auction"])
def test_route_batch_on_card_equals_cpu(mode):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    card, requests = storm("cuda")
    cpu, _ = storm("cpu")
    kernels.route_pick.launches = 0
    got = card.route_batch(requests, mode=mode)
    assert kernels.route_pick.launches >= 1
    want = cpu.route_batch(requests, mode=mode)
    assert [dataclasses.asdict(d) for d in got] == \
        [dataclasses.asdict(d) for d in want]
    assert card.metrics["solver_routed"].value(mode) == len(requests)
