"""Plan/execute: compile a DTSVM problem once, iterate it many times (twin
of ``repro/engine/plan.py``).

``compile_problem`` precomputes the problem's invariants (``invariants``:
Z, K, u, a, counts, box, L) into a ``Plan``; ``Plan.step`` / ``Plan.run``
execute the state-dependent part of eqs. 6-9: the linear term q, the
dual solve with the chosen engine (``qp_engines``), zl = Z^T lam and the
primal/multiplier updates.  The reference's ``lax.scan`` is a Python
loop here; with a ``repro_torch.obs.Telemetry`` it also collects the
per-iteration convergence streams, without a sync.  ``Plan.replan`` is
the incremental path for membership changes: it rebuilds only the
invariants they touch.  The build, the loop and a replan are spans
(``plan_compile``, ``scan_execute``, ``plan_replan``).

A plan with ``qp_precision="bf16"`` and a materialized K converts K to
bf16 once, when it is built, and hands that K to every solve
(``Plan.solve_K``); the invariants keep the f32 K.  The reference
converts in every solve: the same bits, since K is fixed for the plan's
life.  The plan holds 2·V·T·N² bytes more between solves, and no solve
makes a K-sized temporary.
"""
from __future__ import annotations

import hashlib
from typing import Callable, Optional

import torch

from repro_torch.core import dtsvm as core
from repro_torch.engine import invariants as inv_lib
from repro_torch.engine import qp_engines
from repro_torch.kernels import ops as kops
from repro_torch.obs import spans as obs_spans
from repro_torch.obs import telemetry as obs_telemetry

DEFAULT_QP_SOLVER = "fista"


def consensus_update(prob: core.DTSVMProblem, state: core.DTSVMState,
                     u, ntp, nbr, f, zl, nbr_reduce: Callable):
    """Eqs. (7)-(9): the post-dual-solve primal/multiplier updates.
    Returns ``(r_new, alpha, beta)``."""
    p = prob.X.shape[-1]
    rhs = torch.cat([zl, zl], -1) - f                          # [I,I]^T(..)-f
    r_new = rhs / u                                            # eq. (7)
    act = prob.active[..., None]
    r_new = r_new * act + state.r * (1.0 - act)                # freeze

    # eq. (8): alpha update on the (w0, b0) block, coupled nodes only
    r_act = r_new * act
    task_sum = r_act.sum(-2, keepdim=True) - r_act
    d_alpha = ntp[..., None] * r_new - task_sum * prob.couple[..., None, None]
    alpha = state.alpha + 0.5 * prob.eta1 * d_alpha[..., : p + 1] * act

    # eq. (9): beta update over active neighbors
    d_beta = nbr[..., None] * r_new - nbr_reduce(r_act)
    beta = state.beta + 0.5 * prob.eta2 * d_beta * act
    return r_new, alpha, beta


def plan_step(prob: core.DTSVMProblem, inv: inv_lib.PlanInvariants,
              state: core.DTSVMState, *, qp_iters: int = 200,
              qp_solver: str = DEFAULT_QP_SOLVER,
              qp_precision: str = "f32",
              qp_operator: str = "materialized",
              nbr_reduce: Optional[Callable] = None) -> core.DTSVMState:
    """One Prop.-1 iteration (eqs. 6-9) on precomputed invariants.  An
    engine with the ``supports_fold`` capability returns zl from the
    same launch as the dual solve; ``qp_operator="factored"`` solves with
    K applied as Z (a (Z^T lam)) (``qp_engines.solve_factored_multi``).
    ``nbr_reduce`` sums an array over each node's neighbors; it is
    called twice, for the f-term and the beta update (the async fabric
    passes its mailbox reduce; default: the dense-adjacency einsum)."""
    p = prob.X.shape[-1]
    if nbr_reduce is None:
        nbr_reduce = core._default_nbr_reduce(prob)
    ntp, nbr, u, Z = inv.ntp, inv.nbr, inv.u, inv.Z

    f = core._f_vec(prob, state, ntp, nbr, nbr_reduce)
    g = f[..., : p + 1] / u[..., : p + 1] + f[..., p + 1:] / u[..., p + 1:]
    q = prob.mask + (Z * g[..., None, :]).sum(-1)

    engine = qp_engines.get(qp_solver)
    if qp_operator == "factored":
        lam, zl = qp_engines.solve_factored_multi(
            Z, inv.a, q, inv.hi, state.lam, iters=qp_iters,
            L=inv.L)                                           # eq. (6)
    elif getattr(engine, "supports_fold", False):
        lam, zl = engine(inv.K, q, inv.hi, state.lam, iters=qp_iters,
                         L=inv.L, precision=qp_precision, Z=Z)  # eq. (6)
    else:
        lam = engine(inv.K, q, inv.hi, state.lam,
                     iters=qp_iters, L=inv.L)                  # eq. (6)
        zl = torch.einsum("...n,...nd->...d", lam,
                          kops.broadcast_z(Z, lam))            # X^T Y lam
    r_new, alpha, beta = consensus_update(prob, state, u, ntp, nbr, f, zl,
                                          nbr_reduce)
    return core.DTSVMState(r=r_new, alpha=alpha, beta=beta, lam=lam)


class Plan:
    """A compiled DTSVM problem: invariants + the per-iteration body.

    ``nbr_reduce`` is the neighbor sum every step uses (None: the
    dense-adjacency einsum); a rank of the ``"shard_map"`` backend
    compiles its node's plan with its collective.

    ``stats`` counts the invariant economy over the plan's lineage:
    ``gram_slices_computed`` / ``gram_slices_reused`` (v,t) Gram blocks
    built vs carried over by ``replan``, and ``replans``.
    """

    def __init__(self, prob: core.DTSVMProblem,
                 inv: inv_lib.PlanInvariants, *, qp_iters: int = 200,
                 qp_solver: str = DEFAULT_QP_SOLVER,
                 qp_precision: str = "f32",
                 qp_operator: str = "materialized",
                 nbr_reduce: Optional[Callable] = None,
                 budget: Optional[inv_lib.PlanBudget] = None,
                 stats: Optional[dict] = None):
        self.prob = prob
        self.inv = inv
        self.qp_iters = qp_iters
        self.qp_solver = qp_solver
        self.qp_precision = qp_precision
        self.qp_operator = qp_operator
        self.budget = budget
        self.nbr_reduce = nbr_reduce
        #: the K the dual solve reads: inv.K, or in bf16 mode inv.K
        #: converted once for the plan's life
        self.solve_K = (inv.K.to(torch.bfloat16)
                        if qp_precision == "bf16" and inv.K is not None
                        else inv.K)
        V, T = prob.X.shape[:2]
        self.stats = stats if stats is not None else {
            "gram_slices_computed": V * T,
            "gram_slices_reused": 0,
            "replans": 0,
        }

    def init_state(self) -> core.DTSVMState:
        return core.init_state(self.prob)

    def step(self, state: core.DTSVMState) -> core.DTSVMState:
        """One ADMM iteration on the precomputed invariants."""
        inv = self.inv._replace(K=self.solve_K)
        return plan_step(self.prob, inv, state, qp_iters=self.qp_iters,
                         qp_solver=self.qp_solver,
                         qp_precision=self.qp_precision,
                         qp_operator=self.qp_operator,
                         nbr_reduce=self.nbr_reduce)

    def run(self, state: Optional[core.DTSVMState] = None, iters: int = 1,
            eval_fn: Optional[Callable] = None, telemetry=None):
        """Run ``iters`` iterations.  Returns (state, history), where
        history stacks ``eval_fn(state)`` after every iteration (or is
        None).

        With ``telemetry`` (a ``repro_torch.obs.Telemetry``) the loop
        also collects the per-iteration convergence diagnostics and the
        return becomes ``(state, history, streams)``.  The collector
        reads each step's input and output and writes nothing into the
        state, so the model outputs are bitwise the telemetry-None
        call's; it reads nothing back to the host, and the streams are
        still on the device (``repro_torch.obs.materialize`` copies
        them after the loop).  The loop is a ``scan_execute`` span."""
        if state is None:
            state = self.init_state()
        hist, rows = [], []
        attrs = {"iters": int(iters)}
        if telemetry is not None:
            attrs["telemetry"] = True
            terms = obs_telemetry.problem_terms(self.prob)
        with obs_spans.span("scan_execute", **attrs):
            for _ in range(iters):
                new = self.step(state)
                if eval_fn is not None:
                    hist.append(eval_fn(new))
                if telemetry is not None:
                    rows.append(telemetry.collect(self.prob, self.inv.hi,
                                                  new, state, terms=terms))
                state = new
        hist = torch.stack(hist) if hist else None
        if telemetry is None:
            return state, hist
        streams = obs_telemetry.stack_rows(rows, telemetry.streams,
                                           self.prob.X.shape[1],
                                           state.r.device)
        return state, hist, streams

    def fingerprint(self) -> str:
        """A content hash of everything that determines the plan's
        execution: every problem and invariant leaf, in field order
        (dtype, shape and raw bytes; a factored plan's absent K is
        skipped), then the QP configuration.  Two plans with equal
        fingerprints step bitwise alike, so the durable session layer
        (``repro_torch.store``) stores this hash instead of the large,
        rebuildable invariants and checks the rebuilt plan against it.
        The hash reads the port's own leaves, so it differs from the
        reference's and between devices whose K differs in a bit."""
        h = hashlib.sha256()
        for leaf in (*self.prob, *self.inv):
            if leaf is None:
                continue
            t = leaf.detach().cpu().contiguous()
            h.update(f"{t.dtype}|{tuple(t.shape)}|".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy())
        h.update(f"|{self.qp_iters}|{self.qp_solver}"
                 f"|{self.qp_precision}|{self.qp_operator}".encode())
        return h.hexdigest()

    def replan(self, *, active=None, couple=None) -> "Plan":
        """A new Plan for changed membership masks, reusing every
        invariant the change does not touch
        (``invariants.update_invariants``).  The budget carries over, so
        rebuilt K slices stream through the same row panels.  The rebuild
        is a ``plan_replan`` span."""
        with obs_spans.span("plan_replan"):
            prob, inv, n = inv_lib.update_invariants(
                self.prob, self.inv, active=active, couple=couple,
                budget=self.budget)
        V, T = prob.X.shape[:2]
        stats = dict(self.stats)
        stats["replans"] += 1
        stats["gram_slices_computed"] += n
        stats["gram_slices_reused"] += V * T - n
        return Plan(prob, inv, qp_iters=self.qp_iters,
                    qp_solver=self.qp_solver,
                    qp_precision=self.qp_precision,
                    qp_operator=self.qp_operator,
                    nbr_reduce=self.nbr_reduce,
                    budget=self.budget, stats=stats)


def compile_problem(prob: core.DTSVMProblem, cfg=None, *,
                    qp_iters: Optional[int] = None,
                    qp_solver: Optional[str] = None,
                    qp_precision: Optional[str] = None,
                    qp_operator: Optional[str] = None,
                    nbr_reduce: Optional[Callable] = None,
                    nbr_counts: Optional[torch.Tensor] = None,
                    budget: Optional[inv_lib.PlanBudget] = None) -> Plan:
    """Precompute every loop-invariant of Prop. 1 into a ``Plan``.

    ``cfg`` is any object with ``qp_iters`` / ``qp_solver`` /
    ``qp_precision`` / ``qp_operator`` / ``budget`` attributes (e.g. a
    ``SolverConfig``); explicit keywords override it.  ``"bf16"``
    precision needs an engine with the ``supports_precision`` capability
    (``"pallas_fused_multi"``); the plan converts K to bf16 once
    (``Plan.solve_K``).  ``qp_operator="factored"`` builds no K
    (``K=None``; L streams through discarded row panels) and needs
    ``qp_solver="pallas_fused_multi"`` and f32.  ``budget`` streams the
    K build through bounded row panels (the large-n path).
    ``nbr_reduce`` is the plan's neighbor sum and ``nbr_counts`` the
    (V, T) active-neighbor counts, precomputed (a rank of the
    ``"shard_map"`` backend passes its collective and its counts).  The
    build is a ``plan_compile`` span around the ``invariant_build`` one.
    """
    if qp_iters is None:
        qp_iters = getattr(cfg, "qp_iters", 200)
    if qp_solver is None:
        qp_solver = getattr(cfg, "qp_solver", DEFAULT_QP_SOLVER)
    if qp_precision is None:
        qp_precision = getattr(cfg, "qp_precision", "f32")
    if qp_operator is None:
        qp_operator = getattr(cfg, "qp_operator", "materialized")
    if budget is None:
        budget = getattr(cfg, "budget", None)
    engine = qp_engines.get(qp_solver)   # fail fast on unknown engines
    if qp_precision not in ("f32", "bf16"):
        raise ValueError(f"unknown qp_precision {qp_precision!r}; "
                         f"expected 'f32' or 'bf16'")
    if qp_operator not in ("materialized", "factored"):
        raise ValueError(f"unknown qp_operator {qp_operator!r}; "
                         f"expected 'materialized' or 'factored'")
    if qp_precision != "f32" and not getattr(engine, "supports_precision",
                                             False):
        raise ValueError(
            f"qp_precision={qp_precision!r} needs a mixed-precision "
            f"engine (qp_solver='pallas_fused_multi'); got {qp_solver!r}")
    if qp_operator == "factored":
        if not getattr(engine, "supports_fold", False):
            raise ValueError(
                f"qp_operator='factored' is validated only with the "
                f"fused multi engine (qp_solver='pallas_fused_multi'); "
                f"got {qp_solver!r}")
        if qp_precision != "f32":
            raise ValueError("qp_operator='factored' is f32-only "
                             "(the low-rank matvec never streams K "
                             "tiles, so bf16 K has nothing to apply to)")
    with obs_spans.span("plan_compile", qp_solver=qp_solver,
                        qp_operator=qp_operator,
                        budgeted=budget is not None):
        inv = inv_lib.compute_invariants(
            prob, nbr_counts=nbr_counts, budget=budget,
            materialize_k=(qp_operator != "factored"))
        return Plan(prob, inv, qp_iters=qp_iters, qp_solver=qp_solver,
                    qp_precision=qp_precision, qp_operator=qp_operator,
                    nbr_reduce=nbr_reduce, budget=budget)
