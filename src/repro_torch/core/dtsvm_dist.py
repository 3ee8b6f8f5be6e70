"""Decentralized execution of DTSVM: one rank per network node (twin of
``repro/core/dtsvm_dist.py``).

The single-host path computes neighbor sums by a dense-adjacency einsum.
Here the V nodes are the V ranks of a ``repro_torch.dist.World``, each
holding ONLY its own node's data (the paper's deployment model: a node
keeps its samples and exchanges decision variables), and the neighbor sum
is a collective:

- ``topology="graph"``: one ``all_gather`` of the rank's (1, T, 2p+2)
  block, then its adjacency row (its row of a (V, V) by (V, T·D)
  product whose other rows are zero, so that it sums in the single-host
  product's order);
- ``topology="ring"``: two point-to-point exchanges with the ring
  neighbors (``dist.batch_isend_irecv``), the reference's two
  ``ppermute``s: only neighbor traffic moves.  It assumes the graph is
  the ring ``core.graph.ring(V)``, as the reference does.

Both reuse the Prop.-1 math through the ``nbr_reduce`` hook: each rank
compiles its node's plan (Z, K, u, counts, box, L) once with
``engine.compile_problem(nbr_reduce=, nbr_counts=)``, its neighbor counts
being its adjacency row times the global ``active`` table, and then runs
``Plan.run``.  The world is gloo on the card too (NCCL refuses two ranks
on one device), and gloo moves host tensors: on the card each neighbor
sum copies the block to pinned host memory, runs the collective there
and copies the result back.  A rank counts its neighbor sums (two per
ADMM iteration: the f-term and the beta update) and those copies; the
staging, the counters and ``world_stats`` (re-exported here) live in
``dist.collectives``, which the other rank backends share.

A rank receives its node's rows ``X[v]``, ``y[v]``, ``mask[v]``,
``active[v]``, ``couple[v]`` and ``adj[v]``, the global ``active`` table
and the scalars (the reference's ``_node_specs``), as numpy; the state
crosses as numpy rows too, and every runner returns the full (V, ...)
state on the caller's device.  The K of a node is built in its rank, by
the Gram kernels on the card (streamed through the tiled kernel under a
binding ``budget``), and the rank's QP engine runs there.  Where a world
cannot start, the fit raises.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import dtsvm
from repro_torch.dist import collectives
from repro_torch.dist import world as world_lib
from repro_torch.dist.collectives import world_stats  # noqa: F401

TOPOLOGIES = ("graph", "ring")
_SCALARS = ("C", "eps1", "eps2", "eta1", "eta2", "box_scale")
_serials = itertools.count(1)


def make_node_world(V: int, device=None, *,
                    timeout: float = world_lib.DEFAULT_TIMEOUT_S
                    ) -> world_lib.World:
    """A world of V ranks, one per network node, on ``device`` (None
    means ``"cuda"``)."""
    return world_lib.World(V, device=device, timeout=timeout)


def check_topology(topology: str) -> None:
    """Raise ``ValueError`` on a topology other than ``"graph"`` or
    ``"ring"``."""
    if topology not in TOPOLOGIES:
        raise ValueError(f"unknown topology {topology!r}; "
                         f"expected 'graph' or 'ring'")


# ---------------------------------------------------------------------------
# rank side
# ---------------------------------------------------------------------------
def _nbr_reduce_for(adjf: torch.Tensor, topology: str,
                    group=None) -> Callable:
    """The calling rank's collective neighbor sum of a (..., 1, T, D)
    block: ``adjf`` is its (1, V) float adjacency row over the members of
    ``group`` (``(ranks, process group)``; None: the whole world, one rank
    per node).  Leading axes (a sweep rank's configs) ride along."""
    import torch.distributed as dist

    ranks, pg = collectives.members(group)
    n, me = len(ranks), ranks.index(world_lib.context().rank)
    counts = collectives.exchange_counts()
    st = collectives.Staging(adjf.device, counts)

    if topology == "ring":
        nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]

        def nbr_reduce(arr):
            counts["nbr_sums"] += 1
            if n == 1:                   # the rank is its own two neighbors
                return arr + arr
            with st.timed():
                send = st.down(arr)
                left, right = st.host(arr.shape), st.host(arr.shape)
                ops = [dist.P2POp(dist.isend, send, nxt, group=pg),
                       dist.P2POp(dist.irecv, left, prv, group=pg),
                       dist.P2POp(dist.isend, send, prv, group=pg),
                       dist.P2POp(dist.irecv, right, nxt, group=pg)]
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
                return st.up(left + right)
    else:
        # the rank's row inside an otherwise zero (n, n) adjacency: the
        # product's row ``me`` is then computed as the single-host
        # product computes it (a (1, n) product sums in another order)
        pad = torch.zeros((n, n), dtype=adjf.dtype, device=adjf.device)
        pad[me] = adjf[0]

        def nbr_reduce(arr):
            counts["nbr_sums"] += 1
            rows = collectives.all_gather(arr, -3, group=group)
            return torch.einsum("vu,...utd->...vtd", pad,
                                rows)[..., me:me + 1, :, :]
    return nbr_reduce


def _node_problem(node: dict, dev: torch.device) -> dtsvm.DTSVMProblem:
    """A rank's (1, ...) problem from its numpy payload; the adjacency
    leaf is the node's (1, V) row."""
    t = lambda a, dtype=torch.float32: torch.from_numpy(a).to(  # noqa: E731
        dev, dtype)
    s = lambda v: torch.tensor(v, dtype=torch.float32,        # noqa: E731
                               device=dev)
    return dtsvm.DTSVMProblem(
        X=t(node["X"]), y=t(node["y"]), mask=t(node["mask"]),
        adj=t(node["adj_row"], torch.bool),
        **{k: s(node[k]) for k in _SCALARS},
        active=t(node["active"]), couple=t(node["couple"]))


def _rank_compile(serial: int, node: dict, topology: str,
                  plan_kw: dict) -> None:
    """Compile the rank's node plan once (its previous plan dropped
    first, so a world holds one node K per rank)."""
    from repro_torch.engine import plan as engine_plan

    ctx = world_lib.context()
    ctx.store.pop("plan", None)
    ctx.store["received"] = {k: tuple(v.shape) for k, v in node.items()
                             if isinstance(v, np.ndarray)}
    prob = _node_problem(node, ctx.device)
    adjf = prob.adj.to(torch.float32)                       # (1, V)
    nbr_counts = torch.einsum(
        "vu,ut->vt", adjf,
        torch.from_numpy(node["active_global"]).to(ctx.device))
    ctx.store["plan"] = (serial, engine_plan.compile_problem(
        prob, nbr_reduce=_nbr_reduce_for(adjf, topology),
        nbr_counts=nbr_counts, **plan_kw))


def _rank_step(serial: int, rows: tuple, iters: int) -> tuple:
    """``iters`` ADMM iterations of the rank's plan from the state rows
    ``rows``; returns the new rows."""
    ctx = world_lib.context()
    held, plan = ctx.store.get("plan", (None, None))
    if held != serial:
        raise RuntimeError("this world has compiled another problem since "
                           "(or none): compile it again")
    state = dtsvm.DTSVMState(*(torch.from_numpy(a).to(ctx.device)
                               for a in rows))
    state, _ = plan.run(state=state, iters=iters)
    return tuple(t.cpu().numpy() for t in state)


def _rank_fit(serial: int, node: dict, topology: str, plan_kw: dict,
              rows: tuple, iters: int) -> tuple:
    _rank_compile(serial, node, topology, plan_kw)
    return _rank_step(serial, rows, iters)


def _rank_nbr_sum(block: np.ndarray, adj_row: np.ndarray,
                  topology: str) -> np.ndarray:
    ctx = world_lib.context()
    adjf = torch.from_numpy(adj_row).to(ctx.device, torch.float32)
    reduce = _nbr_reduce_for(adjf, topology)
    return reduce(torch.from_numpy(block).to(ctx.device)).cpu().numpy()


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------
def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _check_world(world: world_lib.World, prob: dtsvm.DTSVMProblem) -> None:
    V = prob.X.shape[0]
    if world.size != V:
        raise ValueError(f"a world of {world.size} ranks for {V} nodes: "
                         f"the shard_map backend runs one rank per node")
    if world.device.type != prob.X.device.type:
        raise ValueError(f"the world's ranks run on {world.device}, the "
                         f"problem is on {prob.X.device}")


def _node_payloads(prob: dtsvm.DTSVMProblem) -> list:
    """Each node's rows of the problem (as numpy copies of those rows
    alone), the global ``active`` table and the scalars."""
    X, y, mask, adj, active, couple = (
        _host(t) for t in (prob.X, prob.y, prob.mask, prob.adj,
                           prob.active, prob.couple))
    scalars = {k: float(getattr(prob, k)) for k in _SCALARS}
    return [dict(X=X[v:v + 1].copy(), y=y[v:v + 1].copy(),
                 mask=mask[v:v + 1].copy(), adj_row=adj[v:v + 1].copy(),
                 active=active[v:v + 1].copy(),
                 couple=couple[v:v + 1].copy(), active_global=active,
                 **scalars)
            for v in range(X.shape[0])]


def _state_rows(state: dtsvm.DTSVMState) -> list:
    leaves = [_host(t) for t in state]
    return [tuple(a[v:v + 1].copy() for a in leaves)
            for v in range(leaves[0].shape[0])]


def _join_rows(rows: list, dev: torch.device) -> dtsvm.DTSVMState:
    return dtsvm.DTSVMState(*(torch.from_numpy(np.concatenate(leaf)).to(dev)
                              for leaf in zip(*rows)))


def _plan_kw(qp_iters: int, qp_solver: str, budget) -> dict:
    return dict(qp_iters=qp_iters, qp_solver=qp_solver, budget=budget)


def build_runner(world: world_lib.World, *, topology: str = "graph",
                 qp_iters: int = 200, iters: int = 1,
                 qp_solver: str = "fista", budget=None):
    """A reusable ``run(state, prob) -> state`` executing ``iters``
    decentralized ADMM iterations on ``world`` (each rank compiles its
    node's invariants once per call).  For repeated short calls against
    one problem use :func:`build_planned_runner`, which keeps them."""
    check_topology(topology)
    plan_kw = _plan_kw(qp_iters, qp_solver, budget)

    def run(state: dtsvm.DTSVMState,
            prob: dtsvm.DTSVMProblem) -> dtsvm.DTSVMState:
        _check_world(world, prob)
        serial = next(_serials)
        rows = world.run(_rank_fit, [
            (serial, node, topology, plan_kw, st, iters)
            for node, st in zip(_node_payloads(prob), _state_rows(state))])
        return _join_rows(rows, prob.X.device)

    return run


class NodePlans:
    """The handle ``compile_fn`` returns: the plans live in the ranks."""

    def __init__(self, world: world_lib.World, serial: int):
        self.world = world
        self.serial = serial


def build_planned_runner(world: world_lib.World, *, topology: str = "graph",
                         qp_iters: int = 200, iters: int = 1,
                         qp_solver: str = "fista", budget=None):
    """Two-phase decentralized execution: ``(compile_fn, step_fn)``.

    ``inv = compile_fn(prob)`` compiles every node's plan in its rank
    (one Gram build per node) and returns a :class:`NodePlans` handle;
    ``step_fn(state, prob, inv)`` then advances ``iters`` ADMM iterations
    against those plans and returns the full state, so a host loop can
    evaluate every round without recompiling.  A later ``compile_fn`` on
    the same world replaces the plans."""
    check_topology(topology)
    plan_kw = _plan_kw(qp_iters, qp_solver, budget)

    def compile_fn(prob: dtsvm.DTSVMProblem) -> NodePlans:
        _check_world(world, prob)
        serial = next(_serials)
        world.run(_rank_compile, [(serial, node, topology, plan_kw)
                                  for node in _node_payloads(prob)])
        return NodePlans(world, serial)

    def step_fn(state: dtsvm.DTSVMState, prob: dtsvm.DTSVMProblem,
                inv: NodePlans) -> dtsvm.DTSVMState:
        if inv.world is not world:
            raise ValueError("these node plans belong to another world")
        rows = world.run(_rank_step, [(inv.serial, st, iters)
                                      for st in _state_rows(state)])
        return _join_rows(rows, prob.X.device)

    return compile_fn, step_fn


@contextlib.contextmanager
def node_world(prob: dtsvm.DTSVMProblem,
               world: Optional[world_lib.World] = None):
    """``world`` itself, or a world of one rank per node on the
    problem's device, closed when the block ends."""
    if world is not None:
        yield world
        return
    with make_node_world(prob.X.shape[0], prob.X.device) as own:
        yield own


def run_dtsvm_dist(prob: dtsvm.DTSVMProblem, iters: int,
                   world: Optional[world_lib.World] = None,
                   topology: str = "graph", qp_iters: int = 200,
                   state: Optional[dtsvm.DTSVMState] = None,
                   qp_solver: str = "fista", budget=None):
    """Decentralized run: one rank per node (a world started for the
    call when ``world`` is None)."""
    check_topology(topology)
    if state is None:
        state = dtsvm.init_state(prob)
    with node_world(prob, world) as w:
        run = build_runner(w, topology=topology, qp_iters=qp_iters,
                           iters=iters, qp_solver=qp_solver, budget=budget)
        return run(state, prob)


def neighbor_sum(world: world_lib.World, arr: torch.Tensor, adj,
                 topology: str = "graph") -> torch.Tensor:
    """The collective neighbor sum of a (V, T, D) array, rank v giving
    row v and its adjacency row: ``graph`` is ``einsum("vu,utd->vtd",
    adj, arr)``; ``ring`` each node's ring neighbors' rows summed."""
    check_topology(topology)
    adj = np.asarray(_host(adj) if isinstance(adj, torch.Tensor) else adj,
                     np.float32)
    rows = _host(arr)
    out = world.run(_rank_nbr_sum, [
        (rows[v:v + 1].copy(), adj[v:v + 1].copy(), topology)
        for v in range(world.size)])
    return torch.from_numpy(np.concatenate(out)).to(arr.device)
