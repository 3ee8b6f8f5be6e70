"""Batched sweep engine: one compiled plan, many hyper-parameter configs
(twin of ``repro/engine/sweep.py``).

The paper's Figs. 3-6 sweep something (eps grids, C grids, imbalance
scenarios, mixed-network masks) over fixed data.  This module stacks a
config axis S over one shared invariant build:

    shared      Z (the label-signed data) depends only on (X, y, mask)
                and is built once for the whole sweep;
    per-config  the a-diagonal, u, counts, QP box and Gershgorin bound
                are small stacked leaves, and K = Z diag(a) Z^T is built
                for every config at once: one launch of the square Gram
                kernel over S*V*T problems on the card, or, under a
                binding ``PlanBudget``, tiled-kernel panels over them.

The reference runs one ``jax.vmap``-ed ``plan_step``; the port has no
vmap over its CUDA ops, so ``plan_step`` itself takes the stacked problem
(the pieces of ``core.dtsvm`` and ``engine.plan`` count their axes from
the end; the sweep's hyper-parameters are (S, 1, 1, 1) tensors).  One
ADMM iteration of the whole grid is one pass of the step: with
``qp_solver="pallas_fused_multi"`` one launch of the multi kernel over
S*V*T problems, with ``"pallas_fused"`` ``qp_iters`` step launches.  The
per-config scalars are rounded to float32 on the host exactly as the
serial path rounds them, and u/a/counts/box are the serial arithmetic
broadcast over S, so each config's invariants are the serial plan's.
The stacked step runs the same operations as a serial ``Plan.step`` with
a longer batch; whether its bits equal the serial fit's depends on the
batched products (tests/test_torch_sweep.py).

    plan = compile_sweep(prob, cfgs, qp_iters=..., qp_solver=...)
    states, hist = plan.run(iters=60, eval_fn=ev)       # the whole grid
    states, hist = plan.run_chain(iters=60)             # warm-start chain
    states = plan.run_sharded(60)                       # configs over ranks

``run_sharded`` tiles the config axis over the ranks of a
``repro_torch.dist.World`` (``make_sweep_world``), alone (1-D) or beside
the node axis (2-D: a row of V ranks per config block, the neighbor sums
collectives over the row).  Each rank compiles its own sub-sweep with
``compile_sweep(..., nbr_counts=)``, so K never crosses a pipe: a rank
is sent the base problem's data (2-D: its node's rows, adjacency row and
the global ``active`` of its configs) and its configs, and builds its K
with the square Gram kernel (tiled panels under the sweep's budget).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import dtsvm as core
from repro_torch.core import dtsvm_dist
from repro_torch.core.dtsvm_dist import _host
from repro_torch.dist import world as world_lib
from repro_torch.dist.sharding import (DEFAULT_RANKS, check_tiling,
                                       largest_divisor_leq, make_sweep_world)
from repro_torch.engine import invariants as inv_lib
from repro_torch.engine import qp_engines
from repro_torch.engine.plan import DEFAULT_QP_SOLVER, Plan, plan_step

# Hyper-parameters a config may override (every scalar of DTSVMProblem);
# the ``active`` / ``couple`` masks may also vary per config.
SWEEP_FIELDS = ("C", "eps1", "eps2", "eta1", "eta2", "box_scale")
_MASK_FIELDS = ("active", "couple")


def _overrides_of(cfg) -> dict:
    """One sweep entry as a dict of DTSVMProblem field overrides.  A
    mapping is a partial override (missing keys keep the base problem's
    values); a SolverConfig-like object is a complete spec: every scalar
    hyper-parameter it carries is taken."""
    if isinstance(cfg, Mapping):
        d = dict(cfg)
        unknown = set(d) - set(SWEEP_FIELDS) - set(_MASK_FIELDS)
        if unknown:
            raise ValueError(
                f"unknown sweep override(s) {sorted(unknown)}; "
                f"sweepable: {SWEEP_FIELDS + _MASK_FIELDS}")
        return d
    return {k: getattr(cfg, k) for k in SWEEP_FIELDS if hasattr(cfg, k)}


def per_config_problems(prob: core.DTSVMProblem, cfgs: Sequence) -> list:
    """The S problems a serial loop of fits would use: one ``DTSVMProblem``
    per config, sharing the data/graph tensors of ``prob``; scalar
    overrides become 0-d float32 tensors as in ``core.make_problem``.
    Both what ``compile_sweep`` stacks and what the equivalence tests
    compile one by one."""
    if not len(cfgs):
        raise ValueError("empty config grid")
    dev = prob.X.device
    out = []
    for cfg in cfgs:
        d = _overrides_of(cfg)
        pc = prob
        scalars = {k: torch.tensor(float(v), dtype=torch.float32,
                                   device=dev)
                   for k, v in d.items()
                   if k in SWEEP_FIELDS and v is not None}
        if scalars:
            pc = pc._replace(**scalars)
        for k in _MASK_FIELDS:
            if d.get(k) is not None:
                pc = pc._replace(**{k: torch.as_tensor(
                    np.asarray(d[k]), dtype=torch.float32, device=dev)})
        out.append(pc)
    return out


def _check_static(cfgs, qp_iters, qp_solver):
    """Per-fit statics (loop lengths, engine choice) cannot vary along the
    config axis: validate and resolve them once for the whole sweep."""
    for key, explicit, default in (("qp_iters", qp_iters, 200),
                                   ("qp_solver", qp_solver,
                                    DEFAULT_QP_SOLVER)):
        vals = {getattr(c, key) for c in cfgs if hasattr(c, key)}
        if len(vals) > 1:
            raise ValueError(
                f"configs disagree on static {key!r} "
                f"({sorted(map(str, vals))}); a sweep shares one compiled "
                f"loop — split the grid or pass {key}= explicitly")
        if explicit is None:
            explicit = vals.pop() if vals else default
        if key == "qp_iters":
            qp_iters = int(explicit)
        else:
            qp_solver = str(explicit)
    return qp_iters, qp_solver


class SweepPlan:
    """A compiled sweep: S configs stacked over one shared invariant build.

    ``prob`` is the stacked problem: hyper-parameters (S, 1, 1, 1)
    float32 tensors, ``active`` (S, V, T), ``couple`` (S, V), the data
    and graph the base problem's own tensors.  ``inv`` holds the stacked
    invariants: Z shared (no S axis), every other leaf with a leading S.
    """

    def __init__(self, base: core.DTSVMProblem, prob: core.DTSVMProblem,
                 inv: inv_lib.PlanInvariants, config_problems: list, *,
                 qp_iters: int = 200, qp_solver: str = DEFAULT_QP_SOLVER,
                 budget: Optional[inv_lib.PlanBudget] = None):
        self.base = base
        self.prob = prob
        self.inv = inv
        self.config_problems = config_problems
        self.n_configs = len(config_problems)
        self.qp_iters = qp_iters
        self.qp_solver = qp_solver
        self.budget = budget

    def init_state(self) -> core.DTSVMState:
        """Zero ADMM state with a leading config axis: leaves
        (S, V, T, ...)."""
        st = core.init_state(self.base)
        return core.DTSVMState(*[torch.zeros((self.n_configs,) + x.shape,
                                             dtype=x.dtype, device=x.device)
                                 for x in st])

    def step(self, state: core.DTSVMState) -> core.DTSVMState:
        """One ADMM iteration for every config at once."""
        return plan_step(self.prob, self.inv, state, qp_iters=self.qp_iters,
                         qp_solver=self.qp_solver)

    def run(self, state: Optional[core.DTSVMState] = None, iters: int = 1,
            eval_fn: Optional[Callable] = None):
        """Run ``iters`` iterations of the whole grid.  Returns
        ``(states, history)``: state leaves (S, V, T, ...), history
        (iters, S, ...) stacking ``eval_fn`` of the stacked state after
        every iteration (or None).  ``eval_fn`` takes the stacked state:
        ``api.evaluate.risk_eval_fn``'s broadcasts over S."""
        if state is None:
            state = self.init_state()
        hist = []
        for _ in range(iters):
            state = self.step(state)
            if eval_fn is not None:
                hist.append(eval_fn(state))
        if eval_fn is None or not hist:
            return state, None
        return state, torch.stack(hist)

    def run_chain(self, state: Optional[core.DTSVMState] = None,
                  iters: int = 1, eval_fn: Optional[Callable] = None):
        """Run the configs one after another, config s warm-starting from
        config s-1's final state (continuation sweeps), each on its slice
        of the shared invariant build (``config_plan``).

        ``state`` is one unbatched warm start for config 0 (zeros when
        omitted).  Returns ``(states, history)`` shaped as ``run``'s: the
        configs' final states stacked on axis 0, history (iters, S, ...).
        ``eval_fn`` takes one config's state."""
        if state is None:
            state = core.init_state(self.base)
        finals, hists = [], []
        for s in range(self.n_configs):
            state, hist = self.config_plan(s).run(state=state, iters=iters,
                                                  eval_fn=eval_fn)
            finals.append(state)
            hists.append(hist)
        states = core.DTSVMState(*[torch.stack(leaf)
                                   for leaf in zip(*finals)])
        if eval_fn is None or iters == 0:
            return states, None
        return states, torch.stack(hists, 1)        # (iters, S, ...)

    def run_sharded(self, iters: int, *,
                    world: Optional[world_lib.World] = None,
                    n_sweep: Optional[int] = None, node_axis=None,
                    topology: str = "graph",
                    state: Optional[core.DTSVMState] = None
                    ) -> core.DTSVMState:
        """Tile the config axis over the ranks of a world, or with
        ``node_axis`` (any name: the reference's mesh axis) the configs
        beside the nodes on a 2-D world of ``n_sweep`` rows of V ranks,
        the neighbor sums collectives over each row (``topology="graph"
        | "ring"``, as ``core.dtsvm_dist``).  ``world`` (from
        :func:`make_sweep_world`) is used as it is; else one of
        ``n_sweep`` rows (default: the largest divisor of S that is at
        most 4) is started on the plan's device and closed after.  Each
        rank compiles its configs' sub-sweep and runs ``iters``
        iterations of the step with the plan's QP engine.  Returns the
        final stacked states; per-iteration histories stay a single-host
        feature, as in the reference."""
        dtsvm_dist.check_topology(topology)
        S, V = self.n_configs, self.base.X.shape[0]
        dev = self.base.X.device
        if world is not None:
            rows = _world_rows(world, V, node_axis)
            if n_sweep is not None and int(n_sweep) != rows:
                raise ValueError(f"a world of {rows} sweep rows for "
                                 f"n_sweep={n_sweep}")
            if world.device.type != dev.type:
                raise ValueError(f"the world's ranks run on {world.device}, "
                                 f"the sweep is on {dev}")
            n_sweep = rows
        elif n_sweep is None:
            n_sweep = largest_divisor_leq(S, DEFAULT_RANKS)
        check_tiling(S, int(n_sweep), "configs", "sweep")
        if state is None:
            state = self.init_state()
        payloads = (_sweep_payloads_2d(self, int(n_sweep), state)
                    if node_axis is not None
                    else _sweep_payloads_1d(self, int(n_sweep), state))
        kw = dict(qp_iters=self.qp_iters, qp_solver=self.qp_solver,
                  budget=self.budget, topology=topology)
        own = world is None
        with (make_sweep_world(S, V if node_axis is not None else None,
                               n_sweep=n_sweep, device=dev)
              if own else contextlib.nullcontext(world)) as w:
            outs = w.run(_rank_sweep, [(pl, kw, int(iters))
                                       for pl in payloads])
        if node_axis is not None:          # rank s*V + v: row s, node v
            outs = [tuple(np.concatenate(leaf, 1) for leaf in
                          zip(*outs[s * V:(s + 1) * V]))
                    for s in range(int(n_sweep))]
        return core.DTSVMState(*(torch.from_numpy(np.concatenate(leaf))
                                 .to(dev) for leaf in zip(*outs)))

    def config_plan(self, s: int) -> Plan:
        """The serial ``Plan`` of config ``s``, on this sweep's invariant
        slices (no recompute): one grid point through the single-problem
        API."""
        iv = inv_lib.PlanInvariants(*[
            getattr(self.inv, k) if k == "Z" else getattr(self.inv, k)[s]
            for k in inv_lib.PlanInvariants._fields])
        return Plan(self.config_problems[s], iv, qp_iters=self.qp_iters,
                    qp_solver=self.qp_solver, budget=self.budget)


def _world_rows(world: world_lib.World, V: int, node_axis) -> int:
    """The sweep rows of a given world: its ranks (1-D), or its node
    groups, each of V ranks (2-D)."""
    if node_axis is None:
        return world.size
    g = len(world.groups[0]) if world.groups else 0
    if not g or any(len(r) != g for r in world.groups) \
            or len(world.groups) * g != world.size:
        raise ValueError(
            f"{world!r} has no node groups of one size covering it; pass "
            f"a 2-D world (make_sweep_world(n_configs, V))")
    if V % g:
        raise ValueError(f"{V} nodes do not tile evenly over {g} "
                         f"'{node_axis}' devices")
    if g != V:
        raise ValueError(f"node groups of {g} ranks for {V} nodes: the 2-D "
                         f"sweep runs one rank per node")
    return len(world.groups)


def _config_fields(plan: SweepPlan) -> list:
    """Every config as a complete override dict (its six scalars as
    floats, its masks as numpy), read back from its problem."""
    return [{**{k: float(getattr(pc, k)) for k in SWEEP_FIELDS},
             "active": _host(pc.active), "couple": _host(pc.couple)}
            for pc in plan.config_problems]


def _base_part(prob: core.DTSVMProblem, v=None) -> dict:
    """The base problem as numpy: whole, or node v's rows (its adjacency
    row as ``adj``)."""
    sl = slice(None) if v is None else slice(v, v + 1)
    return dict(X=_host(prob.X)[sl].copy(), y=_host(prob.y)[sl].copy(),
                mask=_host(prob.mask)[sl].copy(),
                adj=_host(prob.adj)[sl].copy(),
                active=_host(prob.active)[sl].copy(),
                couple=_host(prob.couple)[sl].copy(),
                **{k: float(getattr(prob, k)) for k in SWEEP_FIELDS})


def _sweep_payloads_1d(plan: SweepPlan, n_sweep: int, state) -> list:
    """Rank s: the base problem and configs [s S/n, (s+1) S/n) with
    their state rows."""
    Sl, cfgs = plan.n_configs // n_sweep, _config_fields(plan)
    base, leaves = _base_part(plan.base), [_host(t) for t in state]
    return [dict(base=base, cfgs=cfgs[s * Sl:(s + 1) * Sl],
                 state=tuple(a[s * Sl:(s + 1) * Sl].copy() for a in leaves))
            for s in range(n_sweep)]


def _sweep_payloads_2d(plan: SweepPlan, n_sweep: int, state) -> list:
    """Rank s*V + v: node v's rows of the base problem, its adjacency
    row, its configs' masks at node v and their global ``active`` (the
    neighbor counts), and node v's state rows of those configs."""
    V = plan.base.X.shape[0]
    Sl, cfgs = plan.n_configs // n_sweep, _config_fields(plan)
    leaves = [_host(t) for t in state]
    out = []
    for s in range(n_sweep):
        mine = cfgs[s * Sl:(s + 1) * Sl]
        act = np.stack([c["active"] for c in mine])          # (Sl, V, T)
        for v in range(V):
            out.append(dict(
                base=_base_part(plan.base, v), active_global=act,
                cfgs=[{**c, "active": c["active"][v:v + 1].copy(),
                       "couple": c["couple"][v:v + 1].copy()}
                      for c in mine],
                state=tuple(a[s * Sl:(s + 1) * Sl, v:v + 1].copy()
                            for a in leaves)))
    return out


def _rank_sweep(payload: dict, kw: dict, iters: int) -> tuple:
    """A sweep rank: compile its sub-sweep, run ``iters`` iterations from
    its state rows, return the final rows (numpy)."""
    ctx = world_lib.context()
    dev = ctx.device
    b = payload["base"]
    ctx.store["received"] = {
        k: tuple(v.shape) for part in (b, payload)
        for k, v in part.items() if isinstance(v, np.ndarray)}
    t = lambda a, dtype=torch.float32: torch.from_numpy(  # noqa: E731
        np.asarray(a)).to(dev, dtype)
    prob = core.DTSVMProblem(
        X=t(b["X"]), y=t(b["y"]), mask=t(b["mask"]),
        adj=t(b["adj"], torch.bool),
        **{k: torch.tensor(b[k], dtype=torch.float32, device=dev)
           for k in SWEEP_FIELDS},
        active=t(b["active"]), couple=t(b["couple"]))
    nbr_counts, nbr_reduce = None, None
    if "active_global" in payload:                         # 2-D
        adjf = prob.adj.to(torch.float32)                  # (1, V)
        nbr_counts = torch.einsum("vu,sut->svt", adjf,
                                  t(payload["active_global"]))
        nbr_reduce = dtsvm_dist._nbr_reduce_for(adjf, kw["topology"],
                                                group=ctx.group())
    plan = compile_sweep(prob, payload["cfgs"], qp_iters=kw["qp_iters"],
                         qp_solver=kw["qp_solver"], budget=kw["budget"],
                         nbr_counts=nbr_counts)
    st = core.DTSVMState(*(t(a) for a in payload["state"]))
    for _ in range(iters):
        st = plan_step(plan.prob, plan.inv, st, qp_iters=plan.qp_iters,
                       qp_solver=plan.qp_solver, nbr_reduce=nbr_reduce)
    return tuple(_host(x) for x in st)


def compile_sweep(prob: core.DTSVMProblem, cfgs: Sequence, *,
                  qp_iters: Optional[int] = None,
                  qp_solver: Optional[str] = None,
                  nbr_counts: Optional[torch.Tensor] = None,
                  budget: Optional[inv_lib.PlanBudget] = None) -> SweepPlan:
    """Compile S hyper-parameter configs over ``prob``'s data into one
    ``SweepPlan``.

    ``cfgs``: override mappings (keys among ``SWEEP_FIELDS`` and
    ``active``/``couple``) or SolverConfig-like objects; their statics
    (``qp_iters``, ``qp_solver``) must agree, and ``qp_iters`` /
    ``qp_solver`` set them explicitly.  ``nbr_counts``: the (V, T)
    active-neighbor counts precomputed, for every config, or (S, V, T),
    one table per config (a 2-D sweep rank holds one adjacency row and
    counts against each config's global ``active``).  ``budget``: a
    ``PlanBudget`` for the stacked (S, V, T, N, N) K build, S times a
    single fit's K; a binding budget streams it through tiled-kernel row
    panels over all S*V*T problems, bitwise the dense stacked K.
    """
    qp_iters, qp_solver = _check_static(cfgs, qp_iters, qp_solver)
    qp_engines.get(qp_solver)            # fail fast on unknown engines
    for key, default in (("qp_precision", "f32"),
                         ("qp_operator", "materialized")):
        bad = {getattr(c, key) for c in cfgs
               if getattr(c, key, default) != default}
        if bad:
            raise ValueError(
                f"compile_sweep shares one stacked materialized-K build; "
                f"{key}={sorted(bad)} is per-fit only — use "
                f"compile_problem/SolverConfig for non-default QP modes")
    probs = per_config_problems(prob, cfgs)

    def stack_f32(field):
        # (S, 1, 1, 1): broadcasts against the stacked (S, V, T, .) leaves
        return torch.stack([getattr(pc, field) for pc in probs]).reshape(
            -1, 1, 1, 1)

    sweep_prob = prob._replace(
        **{k: stack_f32(k) for k in SWEEP_FIELDS},
        active=torch.stack([pc.active for pc in probs]),
        couple=torch.stack([pc.couple for pc in probs]))
    # elementwise per config, and counts exact in f32: each config's slice
    # is bitwise its serial plan's
    ntp, nbr, u, a, hi = inv_lib._masks_part(sweep_prob, nbr_counts)
    Z = inv_lib.compute_z(prob)
    K, L = inv_lib.gram_and_lipschitz(Z, a, budget)   # Z shared under a
    inv = inv_lib.PlanInvariants(ntp=ntp, nbr=nbr, u=u, a=a, Z=Z, K=K,
                                 hi=hi, L=L)
    return SweepPlan(prob, sweep_prob, inv, probs, qp_iters=qp_iters,
                     qp_solver=qp_solver, budget=budget)
