"""``sweep_fit``: a whole hyper-parameter grid as one fit call (twin of
``repro/api/sweep.py``).

The paper's Figs. 3-6 each sweep something over fixed data.  A serial
loop calls ``fit()`` per grid point; ``sweep_fit`` compiles the grid
once through ``repro_torch.engine.sweep`` (one Gram build for every
config) and runs every config in one batched loop:

    res = sweep_fit(X, y, [{"eps1": e1, "eps2": e2} for e1 in G for e2 in G],
                    mask=mask, adj=adj, base=SolverConfig(iters=60),
                    X_test=X_test, y_test=y_test, device="cuda")
    res.final_global_risks()        # (S, T): what the figures plot
    res.history                     # (iters, S, V, T) risk curves

Each config is a mapping of partial overrides (keys: C, eps1, eps2,
eta1, eta2, box_scale, active, couple) applied on top of ``base``, or a
full ``SolverConfig``, which is a complete spec: all six scalar
hyper-parameters come from it, and ``base`` then supplies only the
statics and the active/couple masks.  Statics (iters, qp_iters,
qp_solver, backend) cannot vary inside one sweep.  ``dsvm_overrides``
expresses the paper's DSVM baseline as a config, so a DTSVM-vs-DSVM
comparison on shared data (Figs. 5/6) is a 2-config sweep.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import backends, evaluate
from repro_torch.api.solvers import SolverConfig
from repro_torch.core import dsvm as dsvm_lib
from repro_torch.core import dtsvm as core
from repro_torch.engine import sweep as sweep_lib


def dsvm_overrides(V: int, *, active=None) -> Dict[str, Any]:
    """The DSVM baseline (Forero et al.) as sweep-config overrides:
    coupling off, the shared term forced to zero, Forero's V*C box (the
    field values of ``core.dsvm.dsvm_problem_fields``)."""
    d = dict(dsvm_lib.dsvm_problem_fields(V))
    if active is not None:
        d["active"] = active
    return d


@dataclass
class SweepResult:
    """Stacked outcome of one sweep: every array carries a leading config
    axis S (in ``history`` it is axis 1: (iters, S, V, T))."""
    configs: List
    states: core.DTSVMState              # leaves (S, V, T, ...)
    history: Optional[np.ndarray]        # (iters, S, V, T) risks or None
    plan: sweep_lib.SweepPlan
    chained: bool = False

    def __len__(self) -> int:
        return self.plan.n_configs

    def state_of(self, s: int) -> core.DTSVMState:
        """The final ADMM state of config ``s`` (unbatched leaves)."""
        return core.DTSVMState(*[x[s] for x in self.states])

    def risks(self, X_test, y_test) -> torch.Tensor:
        """(S, V, T) per-config/node/task risks on the shared test set."""
        return evaluate.risks_of_state(self.states, X_test, y_test)

    def global_risks(self, X_test, y_test) -> np.ndarray:
        """(S, T) network-average risks per config."""
        return self.risks(X_test, y_test).cpu().numpy().mean(axis=-2)

    def final_risks(self) -> np.ndarray:
        """(S, V, T) last-iteration risks from the recorded curve."""
        if self.history is None:
            raise ValueError("no history: pass X_test/y_test to sweep_fit")
        return np.asarray(self.history[-1])

    def final_global_risks(self) -> np.ndarray:
        """(S, T) last-iteration network-average risks from the curve."""
        return self.final_risks().mean(axis=-2)


def _split_grid(cfgs: Sequence, base: Optional[SolverConfig]):
    """Resolve the statics (iters/qp/backends) and the per-config
    override list from a mixed grid of mappings and SolverConfigs."""
    base = base if base is not None else SolverConfig()
    solver_cfgs = [c for c in cfgs if isinstance(c, SolverConfig)]
    if base.net is not None or any(c.net is not None for c in solver_cfgs):
        raise ValueError(
            "SolverConfig.net is a single-fit (async backend) feature; "
            "the batched sweep runs the synchronous engine — fit lossy "
            "configs one at a time through DTSVM(cfg.replace(net=...))")
    for key in ("iters", "qp_iters", "qp_solver", "backend"):
        vals = {getattr(c, key) for c in solver_cfgs}
        vals.add(getattr(base, key))
        if len(vals) > 1:
            raise ValueError(
                f"configs disagree on static {key!r} "
                f"({sorted(map(str, vals))}); a sweep shares one compiled "
                f"loop — split the grid")
    return base, list(cfgs)


def sweep_fit(X, y, cfgs: Sequence, mask=None, adj=None, *,
              base: Optional[SolverConfig] = None, active=None, couple=None,
              iters: Optional[int] = None, X_test=None, y_test=None,
              chain: bool = False, state: Optional[core.DTSVMState] = None,
              backend: Optional[str] = None,
              backend_options: Optional[Dict[str, Any]] = None,
              device=None) -> SweepResult:
    """Fit every config of a hyper-parameter grid in one batched run on
    ``device`` (``None`` means ``"cuda"``).

    The data layout is the repo-wide one (X (V,T,N,p), y/mask (V,T,N),
    test sets (T,n,p) shared by the nodes); ``base`` fills the
    hyper-parameters a mapping config leaves out and supplies the statics
    (a ``SolverConfig`` config sets all six scalars itself).  ``chain``
    runs the grid in order with warm starts (config s starts from config
    s-1's final state).  ``backend``: ``"vmap"`` (default) or
    ``"shard_map"``, the configs (with ``backend_options["node_axis"]``
    also the nodes) tiled over the ranks of a world
    (``SweepPlan.run_sharded``; final states only, no history).
    ``base.budget`` (a ``PlanBudget``) streams the stacked (S, V, T, N,
    N) Gram build through bounded row panels.
    """
    base, cfgs = _split_grid(cfgs, base)
    dev = device_lib.resolve(device)
    prob = core.make_problem(
        X, y, mask, adj, C=base.C, eps1=base.eps1, eps2=base.eps2,
        eta1=base.eta1, eta2=base.eta2, box_scale=base.box_scale,
        active=active, couple=couple, device=dev)
    plan = sweep_lib.compile_sweep(prob, cfgs, qp_iters=base.qp_iters,
                                   qp_solver=base.qp_solver,
                                   budget=base.budget)
    eval_fn = None
    if X_test is not None:
        eval_fn = evaluate.risk_eval_fn(prob.X.shape[0], X_test, y_test,
                                        dev)
    states, hist = backends.run_sweep(
        plan, iters if iters is not None else base.iters,
        backend=backend if backend is not None else base.backend,
        state=state, eval_fn=eval_fn, chain=chain,
        **(backend_options if backend_options is not None
           else base.backend_options))
    return SweepResult(configs=cfgs, states=states,
                       history=evaluate.risk_curve(hist), plan=plan,
                       chained=chain)
