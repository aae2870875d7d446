"""The placement solver, ported to PyTorch with a hand-written CUDA kernel
for its main loop (``kernels.mega_solve``)."""

from kubeinfer_tpu_torch.solver.core import (
    Assignment,
    ScoreWeights,
    solve,
    solve_greedy,
)
from kubeinfer_tpu_torch.solver.problem import (
    BUCKETS,
    JobSet,
    NodeSet,
    Problem,
    bucket_size,
    pack_problem_arrays,
    problem_from_arrays,
    unpack_problem,
)

__all__ = [
    "BUCKETS",
    "Assignment",
    "JobSet",
    "NodeSet",
    "Problem",
    "ScoreWeights",
    "bucket_size",
    "pack_problem_arrays",
    "problem_from_arrays",
    "solve",
    "solve_greedy",
    "unpack_problem",
]
