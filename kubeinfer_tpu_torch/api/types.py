"""The scheduler policy names users write in their service specs.

A copy of ``kubeinfer_tpu/api/types.py:SchedulerPolicy``: the values are
API strings, so the port keeps them verbatim (``jax-greedy`` names the
batched greedy solve, whichever framework runs it).
"""

from __future__ import annotations

from enum import Enum


class SchedulerPolicy(str, Enum):
    """Which SchedulerBackend places a job's replicas.

    ``NATIVE_GREEDY``: serial first-fit-decreasing scorer in C++ (the
    comparison baseline).
    ``JAX_GREEDY``: batched parallel greedy with conflict resolution.
    ``JAX_AUCTION``: auction assignment, one replica per node.
    """

    NATIVE_GREEDY = "native-greedy"
    JAX_GREEDY = "jax-greedy"
    JAX_AUCTION = "jax-auction"
