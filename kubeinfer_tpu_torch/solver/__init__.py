"""The placement solver, ported to PyTorch with hand-written CUDA kernels
for its two main loops: the class-serialised loop (``kernels.mega_solve``)
and the pipelined round loop's fence, bid and accept
(``kernels.fence``, ``kernels.bid``, ``kernels.accept``)."""

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
