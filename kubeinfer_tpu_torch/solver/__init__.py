"""The placement solver and the batched route solve, ported to PyTorch
with hand-written CUDA kernels: the greedy solve's class-serialised loop
(``kernels.mega_solve``) and pipelined round loop (``kernels.fence``,
``kernels.bid``, ``kernels.accept``), the auction loop
(``kernels.auction_solve``) and the route pick (``kernels.route_pick``)."""

from kubeinfer_tpu_torch.solver.core import (
    Assignment,
    ScoreWeights,
    solve,
    solve_auction,
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
from kubeinfer_tpu_torch.solver.routing import (
    RouteAssignment,
    RouteProblem,
    build_match_plane,
    decode_routes,
    pack_route_arrays,
    solve_routes,
    solved_affinity,
)

__all__ = [
    "BUCKETS",
    "Assignment",
    "JobSet",
    "NodeSet",
    "Problem",
    "RouteAssignment",
    "RouteProblem",
    "ScoreWeights",
    "bucket_size",
    "build_match_plane",
    "decode_routes",
    "pack_problem_arrays",
    "pack_route_arrays",
    "problem_from_arrays",
    "solve",
    "solve_auction",
    "solve_greedy",
    "solve_routes",
    "solved_affinity",
    "unpack_problem",
]
