"""The plan/execute layer: invariants once per fit, then the light ADMM
step with a pluggable dual QP engine; ``compile_sweep`` stacks a grid of
configs over one invariant build (``engine.sweep``)."""
from repro_torch.engine import qp_engines, sweep
from repro_torch.engine.invariants import (PlanBudget, PlanInvariants,
                                           compute_invariants, compute_z,
                                           gram_and_lipschitz,
                                           update_invariants)
from repro_torch.engine.plan import (DEFAULT_QP_SOLVER, Plan,
                                     compile_problem, plan_step)
from repro_torch.engine.sweep import (SweepPlan, compile_sweep,
                                      make_sweep_world, per_config_problems)

__all__ = [
    "DEFAULT_QP_SOLVER", "Plan", "PlanBudget", "PlanInvariants",
    "SweepPlan", "compile_problem", "compile_sweep", "compute_invariants",
    "compute_z", "gram_and_lipschitz", "make_sweep_world",
    "per_config_problems", "plan_step", "qp_engines", "sweep",
    "update_invariants",
]
