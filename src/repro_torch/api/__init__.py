"""repro_torch.api — the user-facing surface of the port.

    from repro_torch.api import (CSVM, DSVM, DTSVM, OnlineSession,
                                 SolverConfig, sweep_fit)
    DTSVM(cfg).fit(X, y, mask=mask, adj=adj, device="cuda")
    sweep_fit(X, y, [dict(eps1=e) for e in grid], mask=mask, adj=adj,
              device="cuda")

- ``solvers``: one fit/predict protocol (``Solver``) over CSVM / DSVM /
  DTSVM
- ``sweep``: ``sweep_fit``, a whole hyper-parameter grid (Figs. 3-6) as
  one batched fit
- ``backends``: the execution registries, for single fits and sweeps
- ``session``: ``OnlineSession``, tasks entering and leaving a live
  network (Fig. 7), re-planned incrementally through ``Plan.replan``
- ``evaluate``: shared risk and residual evaluation

``SolverConfig(net=NetConfig(...))`` routes a fit or a session through
the communication fabric (``repro_torch.net``); ``LinkPolicy``,
``NetConfig``, ``Membership`` and ``MembershipEvent`` are exported here
for that entry point.
"""
from repro_torch.api import backends, evaluate
from repro_torch.api.session import OnlineSession
from repro_torch.api.solvers import CSVM, DSVM, DTSVM, Solver, SolverConfig
from repro_torch.api.sweep import SweepResult, dsvm_overrides, sweep_fit
from repro_torch.engine.invariants import PlanBudget
from repro_torch.net import (LinkPolicy, Membership, MembershipEvent,
                             NetConfig)

__all__ = ["CSVM", "DSVM", "DTSVM", "LinkPolicy", "Membership",
           "MembershipEvent", "NetConfig", "OnlineSession", "PlanBudget",
           "Solver", "SolverConfig", "SweepResult", "backends",
           "dsvm_overrides", "evaluate", "sweep_fit"]
