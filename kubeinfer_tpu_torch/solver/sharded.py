"""Sharded greedy solves over a (jobs, nodes) mesh.

Counterpart of ``kubeinfer_tpu/solver/sharded.py``, with its names. The
reference places the problem on a ``jax.sharding.Mesh`` and lets GSPMD
partition its jnp round loop (``accel="jnp"``: a Pallas call cannot
partition under GSPMD). The port writes the partition out and runs the
round kernels on every shard's plain local tensors:

- each mesh position (a, b) holds the block of the cost field S at node
  slice b and job slice a (``core.cost_block``, the same bits as the
  whole field's), on its device, in the process that owns it
  (``Mesh.owners``); nothing else is sharded: the priority and fence
  ranks, the accept key and every [J] or [N] vector stay whole on every
  process, which is given the same global problem;
- a round (:class:`ShardedField`, the field's ``core.RoundOps``):
  (1) ``kernels.fence`` on every (node slice, job slice), then a MIN
  over the job slices; (2) ``kernels.bid`` on every block against that
  global minimum (the bid kernel's column skip is exact only with it),
  the node index offset by the slice's first node and the bid groups of
  the whole node axis (``kernels.slice_group_size``); (3) the slices'
  (prim, alt) pairs combined over the node slices with the group rule
  (prim the least, alt the least outside prim's group); (4) the [J]
  words gathered over the job slices; (5) ``kernels.accept`` on the
  whole vectors, run by every process, so every process holds the same
  capacities;
- the preemption repair reads one column of S, put together over the
  node slices by the process that owns its job and gathered by the rest.

Every host branch of the solve reads the whole, replicated vectors, so
every process takes it the same way. Across processes the one collective
is ``distributed.all_gather``, folded in rank order. The result is the
unsharded ``solve_greedy(accel="pallas")``'s, bit for bit: sharding is a
placement concern, not a change of semantics. The sharded solve always
takes the pipelined loop, as the reference always takes ``accel="jnp"``:
the mega kernel runs every round in one launch and cannot be split.

In one process the mesh may repeat a device (``["cpu"] * 8``,
``["cuda:0"] * 4``); the whole vectors then live once, on the first
position's device, which also runs the accept.
"""

from __future__ import annotations

import collections
import functools
from dataclasses import dataclass, replace

import torch

from kubeinfer_tpu_torch import distributed
from kubeinfer_tpu_torch.inference.sharding import (
    Mesh,
    _device,
    _object_array,
    _visible_cards,
)
from kubeinfer_tpu_torch.solver import core, kernels
from kubeinfer_tpu_torch.solver.problem import JobSet, NodeSet, Problem

_I32MAX = 0x7FFFFFFF
SHARDED_AUCTION = "ROADMAP Queue 1 entry 13b: the sharded auction"


def make_mesh(
    n_devices: int | None = None,
    job_axis: int | None = None,
    node_axis: int = 1,
    devices=None,
) -> Mesh:
    """A (jobs, nodes) mesh over the first ``n_devices`` devices
    (``devices``, every visible CUDA card when None; a list may repeat a
    device). Default: every device on the jobs axis."""
    devices = (_visible_cards() if devices is None
               else [_device(d) for d in devices])
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    if n_devices < 1:
        raise ValueError("a mesh needs at least one device")
    if node_axis < 1 or n_devices % node_axis:
        raise ValueError(
            f"node_axis {node_axis} must divide the device count "
            f"{n_devices} (have {len(devices)} devices total)"
        )
    if job_axis is None:
        job_axis = n_devices // node_axis
    if job_axis * node_axis != n_devices:
        raise ValueError(
            f"mesh {job_axis}x{node_axis} != device count {n_devices}"
        )
    arr = _object_array(devices[:n_devices]).reshape(job_axis, node_axis)
    return Mesh(arr, ("jobs", "nodes"))


@dataclass
class ShardedProblem:
    """A problem placed on a mesh: ``pieces[(a, b)]`` is position (a, b)'s
    slice (job slice a, node slice b, the ``cached`` rows of its nodes) on
    its device, for this process's positions; ``cols[a]`` and ``rows[b]``
    are the slices' global ranges."""

    mesh: Mesh
    cols: list[slice]
    rows: list[slice]
    pieces: dict


def _slices(n: int, parts: int, what: str) -> list[slice]:
    if n % parts:
        raise ValueError(f"{n} {what} do not split into {parts} equal "
                         "shards (pad the problem to a multiple)")
    w = n // parts
    return [slice(i * w, (i + 1) * w) for i in range(parts)]


def local_positions(mesh: Mesh) -> list[tuple[int, int]]:
    """This process's (job row, node column) positions. A job row lies in
    one process (``distributed.global_mesh`` builds it so)."""
    me = distributed.process_index()
    rows = [a for a in range(mesh.shape["jobs"]) if (mesh.owners[a] == me).any()]
    if any(not (mesh.owners[a] == me).all() for a in rows):
        raise ValueError("a job row of the mesh spans processes")
    return [(a, b) for a in rows for b in range(mesh.shape["nodes"])]


def shard_problem(p: Problem, mesh: Mesh) -> ShardedProblem:
    """Split a Problem over the mesh: job vectors over ``jobs``, node
    vectors and the ``cached`` rows over ``nodes``; each of this
    process's positions gets its slices on its device. The padded sizes
    must divide by the axes (``job_multiple``/``node_multiple``)."""
    cols = _slices(p.jobs.valid.shape[0], mesh.shape["jobs"], "jobs")
    rows = _slices(p.nodes.valid.shape[0], mesh.shape["nodes"], "nodes")
    pieces = {}
    for a, b in local_positions(mesh):
        dev = _device(mesh.devices[a, b])
        jobs = JobSet(**{k: v[cols[a]].to(dev)
                         for k, v in vars(p.jobs).items()})
        nodes = NodeSet(**{k: v[rows[b]].to(dev)
                           for k, v in vars(p.nodes).items()})
        pieces[a, b] = Problem(jobs, nodes)
    return ShardedProblem(mesh, cols, rows, pieces)


class ShardedField:
    """The cost field S as per-position blocks, and the round ops over
    them (``round_ops()``, handed to ``core.run_rounds`` through the
    field). ``ops`` are the per-shard ops (``kernels.fence``/``bid``/
    ``accept`` by default; a caller may pass checking ones). ``tally``
    counts the per-shard calls by ``(op, a, b)``, the accepts by
    ``("accept", process)``."""

    def __init__(self, sp: ShardedProblem, whole: Problem,
                 weights: core.ScoreWeights, v_g: torch.Tensor,
                 v_m: torch.Tensor, ops: core.RoundOps | None = None):
        self.mesh = sp.mesh
        self.cols, self.rows = sp.cols, sp.rows
        self.positions = list(sp.pieces)
        self.job_rows = sorted({a for a, _ in self.positions})
        self.home = whole.device
        self.N = whole.nodes.valid.shape[0]
        self.group = kernels.bid_group_size(self.N)
        self.ops = ops or core.RoundOps(kernels.fence, kernels.bid,
                                        kernels.accept)
        self.tally = collections.Counter()
        self.devices = {pos: _device(self.mesh.devices[pos])
                        for pos in self.positions}
        on_dev = {}
        self.blocks = {}
        for (a, b), dev in self.devices.items():
            if dev not in on_dev:
                on_dev[dev] = (whole.to(dev), v_g.to(dev), v_m.to(dev))
            p, vg, vm = on_dev[dev]
            self.blocks[a, b] = core.cost_block(p, weights, vg, vm,
                                                self.rows[b], self.cols[a])

    def round_ops(self) -> core.RoundOps:
        return core.RoundOps(self.fence, self.bid, self.accept)

    def fence(self, gf, mf, d, md, rankf_eff) -> torch.Tensor:
        """f32[N] fence minimum: every block's, MIN over the job slices."""
        parts = []
        for b, rows in enumerate(self.rows):
            low = None
            for a in self.job_rows:
                dev, cols = self.devices[a, b], self.cols[a]
                m = self.ops.fence(gf[rows].to(dev), mf[rows].to(dev),
                                   d[cols].to(dev), md[cols].to(dev),
                                   rankf_eff[cols].to(dev)).to(self.home)
                self.tally["fence", a, b] += 1
                low = m if low is None else torch.minimum(low, m)
            parts.append(low)
        return functools.reduce(torch.minimum,
                                distributed.all_gather(torch.cat(parts)))

    def bid(self, S, u, gf, mf, d, md, rankf_eff, minrank, current_node, *,
            q_lo, q_scale, q_max, node_idx_bits):
        """(prim, alt) i32[J]: every block's bids (node indices local to
        its slice, offset here), combined over the node slices, gathered
        over the job slices. ``S`` is this field; the blocks are read."""
        q = dict(q_lo=q_lo, q_scale=q_scale, q_max=q_max,
                 node_idx_bits=node_idx_bits, group_size=self.group)
        prims, alts = [], []
        for a in self.job_rows:
            cols = self.cols[a]
            pairs = []
            for b, rows in enumerate(self.rows):
                dev = self.devices[a, b]
                cur = current_node[cols].to(dev)
                if rows.start:
                    cur = cur - rows.start  # incumbents in slice-local index
                pairs.append(self.ops.bid(
                    self.blocks[a, b], u[rows].to(dev), gf[rows].to(dev),
                    mf[rows].to(dev), d[cols].to(dev), md[cols].to(dev),
                    rankf_eff[cols].to(dev), minrank[rows].to(dev), cur, **q))
                self.tally["bid", a, b] += 1
            prim, alt = self._combine(pairs, node_idx_bits)
            prims.append(prim)
            alts.append(alt)
        mine = torch.stack([torch.cat(prims), torch.cat(alts)])
        words = torch.cat(distributed.all_gather(mine), dim=1)
        return words[0], words[1]

    def _combine(self, pairs, node_idx_bits):
        """One job slice's (prim, alt) from its node slices' pairs: the
        words offset to global node indices, prim the least of them, alt
        the least bid outside prim's group, which is a slice's alt where
        the slice meets that group (its bids there are in the group) and
        its prim elsewhere."""
        if len(pairs) == 1:
            return pairs[0]
        big = torch.tensor(_I32MAX, dtype=torch.int32, device=self.home)

        def offset(w, n0):
            w = w.to(self.home)
            return torch.where(w != big, w + n0, w) if n0 else w

        P = torch.stack([offset(p, r.start) for (p, _), r in zip(pairs, self.rows)])
        A = torch.stack([offset(a, r.start) for (_, a), r in zip(pairs, self.rows)])
        prim = P.amin(dim=0)
        lo = torch.div(prim & ((1 << node_idx_bits) - 1), self.group,
                       rounding_mode="floor") * self.group
        starts = torch.tensor([r.start for r in self.rows], dtype=torch.int32,
                              device=self.home)[:, None]
        stops = torch.tensor([r.stop for r in self.rows], dtype=torch.int32,
                             device=self.home)[:, None]
        meets = (starts < lo[None, :] + self.group) & (stops > lo[None, :])
        return prim, torch.where(meets, A, P).amin(dim=0)

    def accept(self, choice, key, d, md, gf, mf, ws=None):
        """The accept on the whole vectors, on this process's home
        device (every process runs it on the same inputs)."""
        self.tally["accept", distributed.process_index()] += 1
        return self.ops.accept(choice, key, d, md, gf, mf, ws)

    def column(self, j: torch.Tensor) -> torch.Tensor:
        """f32[N] column ``S[:, j]``: the blocks of j's job slice put
        together over the node slices by their process, gathered by the
        others. ``j`` is read on the host (it is the same everywhere)."""
        jj = int(j)  # host sync
        w = self.cols[0].stop
        a = jj // w
        owner = int(self.mesh.owners[a, 0])
        if owner == distributed.process_index():
            col = torch.cat([self.blocks[a, b][:, jj - a * w].to(self.home)
                             for b in range(len(self.rows))])
        else:
            col = torch.zeros(self.N, dtype=torch.float32, device=self.home)
        return distributed.all_gather(col)[owner]


def sharded_field(p: Problem, mesh: Mesh,
                  weights: core.ScoreWeights = core.ScoreWeights(),
                  ops: core.RoundOps | None = None
                  ) -> tuple[Problem, core.CostField]:
    """The problem on this process's home device (its first position's)
    and the solve's field, with S in blocks on their positions and the
    sharded round ops attached."""
    sp = shard_problem(p, mesh)
    if not sp.pieces:
        raise ValueError("this process owns no position of the mesh")
    home = _device(mesh.devices[next(iter(sp.pieces))])
    whole = p.to(home)
    f = core.cost_field(whole, weights, with_S=False)
    S = ShardedField(sp, whole, weights, f.v_g, f.v_m, ops)
    return whole, replace(f, S=S, ops=S.round_ops())


def solve_sharded(
    p: Problem,
    mesh: Mesh,
    policy: str = "jax-greedy",
    weights: core.ScoreWeights = core.ScoreWeights(),
    ops: core.RoundOps | None = None,
) -> core.Assignment:
    """Solve ``p`` sharded over ``mesh`` (the greedy policy, seeded, 64
    rounds an invocation, as the reference's ``core.solve``). Every
    process passes the same global problem and gets the same assignment,
    on its home device. ``ops`` are the per-shard round ops."""
    if policy == "jax-auction":
        raise NotImplementedError(
            "solve_sharded: the auction holds its whole price and owner "
            f"state in every block; {SHARDED_AUCTION}")
    if policy != "jax-greedy":
        raise ValueError(f"unknown solver policy {policy!r}")
    whole, f = sharded_field(p, mesh, weights, ops)
    return core.greedy_on_field(whole, f, "pallas", 64, True)
