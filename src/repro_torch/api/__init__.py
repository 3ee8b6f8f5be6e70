"""repro_torch.api — the user-facing surface of the port.

    from repro_torch.api import DSVM, DTSVM, SolverConfig
    DTSVM(cfg).fit(X, y, mask=mask, adj=adj, device="cuda")
"""
from repro_torch.api import backends, evaluate
from repro_torch.api.solvers import DSVM, DTSVM, SolverConfig
from repro_torch.engine.invariants import PlanBudget

__all__ = ["DSVM", "DTSVM", "PlanBudget", "SolverConfig", "backends",
           "evaluate"]
