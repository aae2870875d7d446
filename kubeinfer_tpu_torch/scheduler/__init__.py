"""Scheduler backends: the batched torch solve and the serial baseline."""

from kubeinfer_tpu_torch.scheduler.backends import (
    NativeGreedyBackend,
    SchedulerBackend,
    SolveRequest,
    SolveResult,
    TorchBackend,
    get_backend,
    solve_service_handler,
)

__all__ = [
    "NativeGreedyBackend",
    "SchedulerBackend",
    "SolveRequest",
    "SolveResult",
    "TorchBackend",
    "get_backend",
    "solve_service_handler",
]
