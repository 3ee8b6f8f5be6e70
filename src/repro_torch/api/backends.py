"""Execution backends behind ``Solver.fit`` and ``sweep_fit`` (twin of
``repro/api/backends.py``).

A backend is a callable

    run(prob, iters, *, qp_iters, qp_solver, qp_precision, qp_operator,
        state, eval_fn, **options) -> (DTSVMState, history | None)

The port has the single-host ``"vmap"`` backend (one compiled plan, under
``budget`` the streamed large-n build, one loop); ``"shard_map"``, one
process per network node in a ``repro_torch.dist.World`` with the
neighbor sums as collectives (``core.dtsvm_dist``); ``"async"``, the
same plan stepped over the communication fabric (``repro_torch.net``);
and ``"sample_shard"``, every node's samples split over the ranks of a
world, each building its row panel of K (``repro_torch.dist.sample``).

A sweep backend runs a compiled ``engine.SweepPlan``:

    run(plan, iters, *, state, eval_fn, chain, **options)
        -> (states, history | None)

``"vmap"`` runs the whole grid on one device (``chain=True``: the
warm-start chain); ``"shard_map"`` tiles the configs (and the nodes)
over the ranks of a world (``SweepPlan.run_sharded``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import dtsvm as core
from repro_torch.core import dtsvm_dist
from repro_torch.dist import sample as sample_lib
from repro_torch.engine import invariants as inv_lib
from repro_torch.engine import plan as engine_plan
from repro_torch.net import async_admm
from repro_torch.obs import telemetry as obs_telemetry

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Register a backend runner under ``name`` (decorator)."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable:
    """The registered backend runner for ``name`` (ValueError if
    absent)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def names():
    """Sorted names of every registered fit backend."""
    return sorted(_REGISTRY)


@register("vmap")
def _run_vmap(prob: core.DTSVMProblem, iters: int, *, qp_iters: int = 200,
              qp_solver: str = "fista", qp_precision: str = "f32",
              qp_operator: str = "materialized",
              state: Optional[core.DTSVMState] = None, eval_fn=None,
              plan: Optional[engine_plan.Plan] = None, budget=None,
              telemetry=None, telemetry_out: Optional[dict] = None,
              **_ignored):
    """Single-host backend: one compiled plan, one loop of ADMM steps.

    ``plan`` is a prebuilt plan (e.g. one ``Plan.replan`` made); it must
    agree with ``prob`` and the QP configuration of the call.  ``budget``
    streams the plan's K build through bounded row panels (ignored when
    ``plan`` is given).  ``telemetry`` (a ``repro_torch.obs.Telemetry``)
    collects the per-iteration convergence streams in the same loop (the
    state stays bitwise), and ``telemetry_out`` (a dict) receives them as
    ``{"streams": {name: float32 numpy}}``, copied to the host after the
    loop: the ``(state, history)`` return leaves no slot for them.
    Options of the other backends (e.g. ``topology``) are ignored, as in
    the reference."""
    if plan is None:
        plan = engine_plan.compile_problem(prob, qp_iters=qp_iters,
                                           qp_solver=qp_solver,
                                           qp_precision=qp_precision,
                                           qp_operator=qp_operator,
                                           budget=budget)
    elif (plan.prob is not prob or plan.qp_iters != qp_iters
          or plan.qp_solver != qp_solver
          or plan.qp_precision != qp_precision
          or plan.qp_operator != qp_operator):
        raise ValueError(
            "prebuilt plan= disagrees with the call: pass prob=plan.prob "
            "and matching qp_iters/qp_solver/qp_precision/qp_operator "
            "(or omit plan=)")
    if telemetry is None:
        return plan.run(state=state, iters=iters, eval_fn=eval_fn)
    st, hist, streams = plan.run(state=state, iters=iters, eval_fn=eval_fn,
                                 telemetry=telemetry)
    if telemetry_out is not None:
        telemetry_out["streams"] = obs_telemetry.materialize(streams)
    return st, hist


@register("shard_map")
def _run_shard_map(prob: core.DTSVMProblem, iters: int, *,
                   qp_iters: int = 200, qp_solver: str = "fista",
                   state: Optional[core.DTSVMState] = None, eval_fn=None,
                   topology: str = "graph", world=None, budget=None,
                   telemetry=None, telemetry_out: Optional[dict] = None):
    """One rank per network node; neighbor sums as collectives
    (``core.dtsvm_dist``).

    ``topology`` selects ``"graph"`` (all_gather + adjacency row) or
    ``"ring"`` (two point-to-point exchanges); ``world`` (a
    ``repro_torch.dist.World`` of V ranks, the reference's ``mesh``) is
    used as it is, else a world is started for the call and closed after
    it; ``budget`` streams each node's K build in its rank.  With
    ``eval_fn`` or ``telemetry`` each rank compiles its node's plan once
    and the ranks step one round at a time: each round's state comes back
    to the caller, where ``eval_fn`` and ``telemetry.collect`` read it, as
    in the reference; ``telemetry_out`` receives ``{"streams": {name:
    float32 numpy}}``."""
    dtsvm_dist.check_topology(topology)        # before a world starts
    if eval_fn is None and telemetry is None:
        return dtsvm_dist.run_dtsvm_dist(
            prob, iters, world=world, topology=topology, qp_iters=qp_iters,
            state=state, qp_solver=qp_solver, budget=budget), None
    st = core.init_state(prob) if state is None else state
    with dtsvm_dist.node_world(prob, world) as w:
        compile_fn, run1 = dtsvm_dist.build_planned_runner(
            w, topology=topology, qp_iters=qp_iters, iters=1,
            qp_solver=qp_solver, budget=budget)
        inv = compile_fn(prob)
        hist, rows = [], []
        if telemetry is not None:
            hi = inv_lib._masks_part(prob)[4]
            terms = obs_telemetry.problem_terms(prob)
        for _ in range(iters):
            prev, st = st, run1(st, prob, inv)
            if eval_fn is not None:
                hist.append(eval_fn(st))
            if telemetry is not None:
                rows.append(telemetry.collect(prob, hi, st, prev,
                                              terms=terms))
    if telemetry_out is not None and telemetry is not None:
        telemetry_out["streams"] = obs_telemetry.materialize(
            obs_telemetry.stack_rows(rows, telemetry.streams,
                                     prob.X.shape[1], st.r.device))
    return st, (torch.stack(hist) if eval_fn is not None else None)


@register("async")
def _run_async(prob: core.DTSVMProblem, iters: int, *, qp_iters: int = 200,
               qp_solver: str = "fista",
               state: Optional[core.DTSVMState] = None, eval_fn=None,
               net=None, plan: Optional[engine_plan.Plan] = None,
               fabric=None, fabric_state=None, round0: int = 0,
               meter_out: Optional[dict] = None, budget=None,
               telemetry=None, telemetry_out: Optional[dict] = None,
               membership=None):
    """The communication fabric (``repro_torch.net``): the same compiled
    plan stepped against per-node mailboxes behind lossy, delayed,
    quantized links, with byte metering.  ``net`` is a
    ``repro_torch.net.NetConfig``; ``meter_out`` (a dict) receives the
    byte report, the fabric and its final state; ``budget`` streams the
    plan's K build when no ``plan`` is given; ``membership`` (a
    ``repro_torch.net.Membership``) schedules node enter / leave / crash
    / recover events over the run; ``telemetry`` / ``telemetry_out``
    collect the per-round convergence streams (plus ``bytes_round``,
    ``staleness`` and, under a membership, ``nodes_alive``) from the same
    loop."""
    if plan is not None and (plan.prob is not prob
                             or plan.qp_iters != qp_iters
                             or plan.qp_solver != qp_solver):
        raise ValueError(
            "prebuilt plan= disagrees with the call: pass prob=plan.prob "
            "and matching qp_iters/qp_solver (or omit plan=)")
    res = async_admm.run_async(
        prob, iters, net=net, plan=plan, fabric=fabric,
        fabric_state=fabric_state, qp_iters=qp_iters, qp_solver=qp_solver,
        state=state, eval_fn=eval_fn, round0=round0, budget=budget,
        telemetry=telemetry, membership=membership)
    if meter_out is not None:
        meter_out["report"] = res.report
        meter_out["fabric"] = res.fabric
        meter_out["fabric_state"] = res.fabric_state
    if telemetry_out is not None and res.telemetry is not None:
        telemetry_out["streams"] = res.telemetry
    return res.state, res.history


@register("sample_shard")
def _run_sample_shard(prob: core.DTSVMProblem, iters: int, *,
                      qp_iters: int = 200, qp_solver: str = "fista",
                      state: Optional[core.DTSVMState] = None, eval_fn=None,
                      world=None, n_shards: Optional[int] = None,
                      reduce: str = "gather", budget=None, telemetry=None,
                      telemetry_out: Optional[dict] = None, **_ignored):
    """Every node's local samples split over the ranks of a world (the
    large-n path, ``repro_torch.dist.sample``): rank k builds only its
    N/S row panel of every (v, t) K, the dual QP iterates with the panel
    matvec and one all-gather of the iterate per inner step, and the
    O(p) consensus math is replicated.

    ``world`` (a ``repro_torch.dist.World``, the reference's ``mesh``) is
    used as it is, its size matching ``n_shards`` when both are given;
    else a world of ``n_shards`` ranks (default: the largest divisor of
    N that is at most 4, ``dist.sharding.DEFAULT_RANKS``) is started for
    the call and closed after it.  ``reduce``: ``"gather"`` gathers lam
    and reduces zl densely, ``"psum"`` sums the ranks' partial zl.
    ``budget`` streams each rank's panel build.  ``qp_solver`` must be
    ``"fista"`` or ``"pg"``.  ``eval_fn`` runs in the caller on each
    iteration's state (the world is stepped one iteration at a time);
    ``telemetry`` collects in the ranks
    (``obs.telemetry.collect_shard_diagnostics``) and ``telemetry_out``
    receives ``{"streams": {name: float32 numpy}}``.  Options of the
    other backends are ignored, as in the reference."""
    st, hist, streams = sample_lib.run_sample_shard(
        prob, iters, world=world, n_shards=n_shards, reduce=reduce,
        budget=budget, qp_iters=qp_iters, qp_solver=qp_solver, state=state,
        eval_fn=eval_fn, telemetry=telemetry)
    if telemetry_out is not None and streams is not None:
        telemetry_out["streams"] = streams
    return st, hist


def run(prob: core.DTSVMProblem, iters: int, *, backend: str = "vmap",
        qp_iters: int = 200, qp_solver: str = "fista",
        qp_precision: str = "f32", qp_operator: str = "materialized",
        state=None, eval_fn=None, **options):
    """Dispatch one fit through the named backend.  Returns
    ``(state, history | None)``.  The bf16 and factored QP modes are a
    feature of the ``"vmap"`` backend: any other raises ``ValueError``
    on a non-default ``qp_precision`` / ``qp_operator``, as in the
    reference."""
    if (qp_precision, qp_operator) != ("f32", "materialized"):
        if backend != "vmap":
            raise ValueError(
                f"qp_precision/qp_operator are vmap-backend features; "
                f"backend={backend!r} runs the exact materialized-f32 "
                f"dual path only")
        options = dict(options, qp_precision=qp_precision,
                       qp_operator=qp_operator)
    return get(backend)(prob, iters, qp_iters=qp_iters, qp_solver=qp_solver,
                        state=state, eval_fn=eval_fn, **options)


# -- batched sweeps ---------------------------------------------------------
_SWEEP_REGISTRY: Dict[str, Callable] = {}


def register_sweep(name: str):
    """Register a sweep runner: ``run(plan, iters, *, state, eval_fn,
    chain, **options) -> (states, history | None)`` over a compiled
    ``engine.SweepPlan`` (decorator)."""
    def deco(fn: Callable) -> Callable:
        _SWEEP_REGISTRY[name] = fn
        return fn
    return deco


@register_sweep("vmap")
def _run_sweep_vmap(plan, iters: int, *, state=None, eval_fn=None,
                    chain: bool = False, **_ignored):
    if chain:
        return plan.run_chain(state=state, iters=iters, eval_fn=eval_fn)
    return plan.run(state=state, iters=iters, eval_fn=eval_fn)


@register_sweep("shard_map")
def _run_sweep_shard_map(plan, iters: int, *, state=None, eval_fn=None,
                         chain: bool = False, world=None, n_sweep=None,
                         node_axis=None, topology: str = "graph"):
    """The configs (with ``node_axis``, and the nodes) tiled over the
    ranks of a world (``SweepPlan.run_sharded``); final states only."""
    if chain:
        raise ValueError("warm-start chains are sequential in the config "
                         "axis — use backend='vmap' for chain=True")
    if eval_fn is not None:
        raise ValueError("per-iteration histories are a single-host "
                         "feature; run the sharded sweep without "
                         "X_test/eval_fn and evaluate the final states")
    return plan.run_sharded(iters, world=world, n_sweep=n_sweep,
                            node_axis=node_axis, topology=topology,
                            state=state), None


def run_sweep(plan, iters: int, *, backend: str = "vmap", state=None,
              eval_fn=None, chain: bool = False, **options):
    """Dispatch one batched sweep through the named sweep backend."""
    try:
        fn = _SWEEP_REGISTRY[backend]
    except KeyError:
        raise ValueError(f"unknown sweep backend {backend!r}; available: "
                         f"{sorted(_SWEEP_REGISTRY)}") from None
    return fn(plan, iters, state=state, eval_fn=eval_fn, chain=chain,
              **options)
