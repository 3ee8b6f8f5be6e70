"""One fit/predict surface over the paper's three solvers (twin of
``repro/api/solvers.py``).

    cfg = SolverConfig(C=0.01, eps2=1.0, iters=60)
    DTSVM(cfg).fit(X, y, mask=mask, adj=adj).risks(X_test, y_test)
    DSVM(cfg).fit(X, y, mask=mask, adj=adj).risks(X_test, y_test)
    CSVM(cfg).fit(X, y, mask=mask).risks(X_test, y_test)

All three implement the ``Solver`` protocol.  ``SolverConfig`` keeps the
reference's fields and names, so a ``to_dict()`` dict means the same
thing in both packages.  The device is not part of the config: it goes
to the solver's constructor or to ``fit`` (``None`` means ``"cuda"``;
``repro_torch.device``).  Every backend of the reference runs:
``"vmap"``, ``"async"``, ``"shard_map"`` and ``"sample_shard"``.
A hyper-parameter grid runs as one batched fit through
``repro_torch.api.sweep_fit``.  ``SolverConfig(net=NetConfig(...))``
routes a DTSVM or DSVM fit through the communication fabric
(``repro_torch.net``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, Dict, Optional, Protocol, Tuple,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import backends, evaluate
from repro_torch.core import csvm as csvm_lib
from repro_torch.core import dsvm as dsvm_lib
from repro_torch.core import dtsvm as core
from repro_torch.engine import plan as engine_plan
from repro_torch.engine.invariants import PlanBudget
from repro_torch.net.policies import NetConfig
from repro_torch.obs.telemetry import Telemetry


@dataclass(frozen=True)
class SolverConfig:
    """Hyper-parameters + execution strategy of every solver (the
    reference's fields).

    C, eps1, eps2, eta1, eta2: Prop. 1's penalty, regularization and
    consensus weights.  iters: ADMM iterations per ``fit()``.  qp_iters:
    inner box-QP iterations per ADMM step.  qp_solver: ``"fista" | "pg"
    | "pallas_fused" | "pallas_fused_multi"`` (``engine.qp_engines``).
    qp_precision: ``"f32"`` or ``"bf16"`` (``pallas_fused_multi`` only).
    qp_operator: ``"materialized"`` or ``"factored"`` (no K: the QP
    applies it as Z (a (Z^T lam)); ``pallas_fused_multi`` and f32 only).
    budget: a ``PlanBudget`` that streams the K build through bounded row
    panels (the large-n path).  box_scale: the paper's multiplier on C
    (auto: V*T).  backend: ``"vmap" | "async" | "shard_map" |
    "sample_shard"`` (``api.backends``), with ``backend_options`` passed
    to it (e.g. ``{"n_shards": 4, "reduce": "psum"}``).  net: a
    ``repro_torch.net.NetConfig``, the communication model; it routes
    the default backend to ``"async"`` (the identity ``NetConfig()``
    gives the vmap trajectory bitwise, metered).
    telemetry: collect the per-iteration convergence streams
    (``repro_torch.obs``) into ``telemetry_``; the state stays bitwise
    the telemetry-off fit's.
    """
    C: float = 0.01
    eps1: float = 1.0
    eps2: float = 1.0
    eta1: float = 1.0
    eta2: float = 1.0
    iters: int = 60
    qp_iters: int = 200
    qp_solver: str = "fista"
    qp_precision: str = "f32"
    qp_operator: str = "materialized"
    box_scale: Optional[float] = None
    backend: str = "vmap"
    backend_options: Dict[str, Any] = field(default_factory=dict)
    net: Optional[NetConfig] = None
    budget: Optional[PlanBudget] = None
    telemetry: bool = False

    def replace(self, **kw) -> "SolverConfig":
        """A copy with the given fields replaced (frozen dataclass)."""
        return dataclasses.replace(self, **kw)

    def to_dict(self) -> dict:
        """Plain-python form, key for key the reference's (``net`` through
        ``NetConfig.to_dict``)."""
        for k, v in self.backend_options.items():
            if not isinstance(v, (int, float, str, bool, type(None))):
                raise TypeError(
                    f"SolverConfig.to_dict: backend_options[{k!r}] is a "
                    f"{type(v).__name__}, which has no serializable form")
        return {
            "C": float(self.C), "eps1": float(self.eps1),
            "eps2": float(self.eps2), "eta1": float(self.eta1),
            "eta2": float(self.eta2), "iters": int(self.iters),
            "qp_iters": int(self.qp_iters), "qp_solver": self.qp_solver,
            "qp_precision": self.qp_precision,
            "qp_operator": self.qp_operator,
            "box_scale": None if self.box_scale is None
            else float(self.box_scale),
            "backend": self.backend,
            "backend_options": dict(self.backend_options),
            "net": None if self.net is None else self.net.to_dict(),
            "budget": None if self.budget is None else
            {"max_elems": None if self.budget.max_elems is None
             else int(self.budget.max_elems),
             "tile": None if self.budget.tile is None
             else [int(t) for t in self.budget.tile]},
            "telemetry": bool(self.telemetry),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SolverConfig":
        """Rebuild a SolverConfig from ``to_dict``'s plain form."""
        d = dict(d)
        if d.get("net") is not None:
            d["net"] = NetConfig.from_dict(d["net"])
        if d.get("budget") is not None:
            b = d["budget"]
            d["budget"] = PlanBudget(
                max_elems=b["max_elems"],
                tile=None if b["tile"] is None else tuple(b["tile"]))
        return cls(**d)


def _as_solver_config(config: Optional[SolverConfig],
                      overrides: dict) -> SolverConfig:
    """``config`` (default: ``SolverConfig()``) with ``overrides``
    replaced."""
    cfg = config if config is not None else SolverConfig()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def effective_backend(cfg: SolverConfig) -> str:
    """The backend a config actually runs: a communication model
    (``cfg.net``) promotes the default "vmap" to "async" and is invalid
    with any other backend.  Shared by the solvers and the
    ``OnlineSession``, as in the reference."""
    if cfg.net is not None:
        if cfg.backend == "vmap":
            return "async"
        if cfg.backend != "async":
            raise ValueError(f"SolverConfig.net is an async-backend "
                             f"feature; got backend={cfg.backend!r}")
    return cfg.backend


@runtime_checkable
class Solver(Protocol):
    """What every solver exposes; see the module doc for the data layout."""

    config: SolverConfig

    def init_state(self, prob):
        """Zero state for ``prob`` (a ``core.DTSVMState`` for the
        consensus solvers)."""

    def step(self, state, prob):
        """One algorithm iteration ``state -> state``."""

    def fit(self, X, y, mask=None, adj=None, **kw) -> "Solver":
        """Train on X (V, T, N, p) / y (V, T, N); returns self."""

    def predict(self, X):
        """Predicted labels in {-1, +1} for test inputs."""

    def risks(self, X_test, y_test):
        """Misclassification rates on a shared (T, n, p) test set."""

    def residuals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(task, node) consensus-constraint violations of the fit."""


class _ConsensusSolver:
    """Shared machinery for the two decentralized solvers."""

    def __init__(self, config: Optional[SolverConfig] = None, *,
                 device=None, **overrides):
        self.config = _as_solver_config(config, overrides)
        self.device = device
        self.problem_: Optional[core.DTSVMProblem] = None
        self.state_: Optional[core.DTSVMState] = None
        self.history_ = None
        self.net_report_: Optional[Dict[str, Any]] = None   # async backend
        #: {stream: float32 numpy} when config.telemetry (repro_torch.obs)
        self.telemetry_: Optional[Dict[str, np.ndarray]] = None

    # -- problem construction (the one subclass hook) ----------------------
    def make_problem(self, X, y, mask=None, adj=None, *, active=None,
                     couple=None, device=None) -> core.DTSVMProblem:
        raise NotImplementedError

    # -- protocol ----------------------------------------------------------
    def init_state(self, prob: core.DTSVMProblem) -> core.DTSVMState:
        return core.init_state(prob)

    def step(self, state: core.DTSVMState,
             prob: core.DTSVMProblem) -> core.DTSVMState:
        """One Prop.-1 ADMM iteration on ``prob``'s device, with the
        configured QP engine.  One-shot: it compiles the problem's
        invariants on every call, as the reference does; a loop holds a
        plan instead (``engine.compile_problem`` + ``plan.step``)."""
        return engine_plan.compile_problem(prob, self.config).step(state)

    def fit(self, X, y, mask=None, adj=None, *, active=None, couple=None,
            iters: Optional[int] = None,
            state: Optional[core.DTSVMState] = None, eval_fn=None,
            X_test=None, y_test=None, membership=None, device=None):
        """Run ADMM on (X, y) on ``device`` (default: the constructor's,
        else ``"cuda"``).  Returns self; the state and history are on
        ``state_`` / ``history_``, and over the fabric the byte report
        on ``net_report_``, with ``config.telemetry`` the per-iteration
        convergence streams on ``telemetry_``.  ``state`` warm-starts;
        ``X_test`` / ``y_test`` record a per-iteration risk curve;
        ``membership`` (a ``repro_torch.net.Membership``) schedules node
        enter / leave / crash / recover events over the fit, an
        async-backend feature."""
        cfg = self.config
        backend, options = effective_backend(cfg), dict(cfg.backend_options)
        if membership is not None:
            if backend != "async":
                raise ValueError(
                    "membership= models node churn over the communication "
                    "fabric; configure SolverConfig(net=NetConfig(...)) "
                    "or backend='async'")
            options["membership"] = membership
        dev = device_lib.resolve(device if device is not None
                                 else self.device)
        prob = self.make_problem(X, y, mask, adj, active=active,
                                 couple=couple, device=dev)
        if eval_fn is None and X_test is not None:
            eval_fn = evaluate.risk_eval_fn(prob.X.shape[0], X_test, y_test,
                                            dev)
        # one options dict, as in the reference: cfg.net and cfg.budget
        # fill in what backend_options does not already name
        if cfg.net is not None:
            options.setdefault("net", cfg.net)
        if cfg.budget is not None:
            options.setdefault("budget", cfg.budget)
        if backend == "async":
            options.setdefault("meter_out", {})
        if cfg.telemetry:
            options.setdefault("telemetry", Telemetry())
            options.setdefault("telemetry_out", {})
        self.state_, self.history_ = backends.run(
            prob, iters if iters is not None else cfg.iters,
            backend=backend, qp_iters=cfg.qp_iters,
            qp_solver=cfg.qp_solver, qp_precision=cfg.qp_precision,
            qp_operator=cfg.qp_operator, state=state, eval_fn=eval_fn,
            **options)
        self.net_report_ = options.get("meter_out", {}).get("report")
        self.telemetry_ = options.get("telemetry_out", {}).get("streams")
        self.problem_ = prob
        return self

    # -- inference ---------------------------------------------------------
    def _require_fit(self) -> core.DTSVMState:
        if self.state_ is None:
            raise RuntimeError("call fit() first")
        return self.state_

    def decision(self, X) -> torch.Tensor:
        """Decision values g_vt(x).  X: (T, n, p) shared, or (V, T, n, p)."""
        st = self._require_fit()
        X = torch.as_tensor(X, dtype=torch.float32, device=st.r.device)
        if X.ndim == 3:
            X = X[None].expand((st.r.shape[0],) + X.shape)
        return core.decision_values(st.r, X)

    def predict(self, X) -> torch.Tensor:
        """Predicted labels in {-1, +1}, shape (V, T, n)."""
        return torch.sign(self.decision(X))

    def risks(self, X_test, y_test) -> torch.Tensor:
        """(V, T) per-node test risks on the shared test set."""
        return evaluate.risks_of_state(self._require_fit(), X_test, y_test)

    def global_risks(self, X_test, y_test) -> np.ndarray:
        """(T,) network-average risks (what the figures plot)."""
        return evaluate.global_risks(self.risks(X_test, y_test))

    def residuals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(task, node) consensus residuals of the fitted state."""
        return core.consensus_residuals(self._require_fit(), self.problem_)


class DTSVM(_ConsensusSolver):
    """Prop. 1: decentralized multi-task transfer SVM."""

    def make_problem(self, X, y, mask=None, adj=None, *, active=None,
                     couple=None, device=None) -> core.DTSVMProblem:
        """The Prop.-1 problem from user arrays; hyper-parameters from
        ``self.config``."""
        cfg = self.config
        return core.make_problem(
            X, y, mask, adj, C=cfg.C, eps1=cfg.eps1, eps2=cfg.eps2,
            eta1=cfg.eta1, eta2=cfg.eta2, box_scale=cfg.box_scale,
            active=active, couple=couple, device=device)


class DSVM(_ConsensusSolver):
    """Forero et al. single-task consensus SVM, the paper's baseline [7].
    ``couple`` is forced to 0; ``eps1``/``eta1`` of the config are
    ignored by construction."""

    def make_problem(self, X, y, mask=None, adj=None, *, active=None,
                     couple=None, device=None) -> core.DTSVMProblem:
        cfg = self.config
        return dsvm_lib.make_dsvm_problem(
            X, y, mask, adj, C=cfg.C, eps2=cfg.eps2, eta2=cfg.eta2,
            active=active, device=device)


class CSVM:
    """Centralized pooled SVM per task, the paper's baseline [13].

    The same surface, other math: all nodes' data of a task is pooled and
    one box QP is solved per task, all tasks in one batched solve (one
    Gram launch on the card).  ``fit`` takes the (V, T, N, p) layout of
    the consensus solvers, or plain (N, p) single-task data.  ``C_scale``
    multiplies the config's C.
    """

    def __init__(self, config: Optional[SolverConfig] = None, *,
                 C_scale: float = 1.0, device=None, **overrides):
        self.config = _as_solver_config(config, overrides)
        self.C_scale = C_scale
        self.device = device
        self.w_: Optional[torch.Tensor] = None      # (T, p)
        self.b_: Optional[torch.Tensor] = None      # (T,)
        self.history_ = None

    def init_state(self, prob=None):
        """The fitted (w (T, p), b (T,)) pair: CSVM has no ADMM state."""
        return (self.w_, self.b_)

    def step(self, state, prob):
        """CSVM is a direct (single-shot) solver: always raises."""
        raise NotImplementedError(
            "CSVM is a direct (single-shot) solver; use fit()")

    def fit(self, X, y, mask=None, adj=None, *, device=None,
            **_ignored) -> "CSVM":
        """Pool all nodes' data per task and solve one box QP per task on
        ``device`` (default: the constructor's, else ``"cuda"``).  ``adj``
        is accepted and ignored, so swapping CSVM for DTSVM stays a
        one-line change.  Returns self."""
        if self.config.net is not None:
            raise ValueError("SolverConfig.net models a decentralized "
                             "network; CSVM is centralized (no links to "
                             "model) — drop net or use DSVM/DTSVM")
        if self.config.telemetry:
            raise ValueError("SolverConfig.telemetry streams the ADMM "
                             "loop's consensus diagnostics; CSVM is a "
                             "direct (single-shot) solver — drop "
                             "telemetry or use DSVM/DTSVM")
        dev = device_lib.resolve(device if device is not None
                                 else self.device)
        f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
        X, y = f32(X), f32(y)
        if X.ndim == 2:                       # single task, pooled already
            X, y = X[None, None], y[None, None]
        V, T, N, p = X.shape
        mask = (torch.ones((V, T, N), dtype=torch.float32, device=dev)
                if mask is None else f32(mask).reshape(V, T, N))
        # nodes pooled per task: (V, T, N, ...) -> (T, V*N, ...)
        pool = lambda a: a.transpose(0, 1).reshape((T, V * N) + a.shape[3:])
        self.w_, self.b_ = csvm_lib.csvm_fit_tasks(
            pool(X), pool(y), self.config.C * self.C_scale, pool(mask),
            qp_iters=self.config.qp_iters)
        return self

    def _require_fit(self):
        if self.w_ is None:
            raise RuntimeError("call fit() first")

    def decision(self, X) -> torch.Tensor:
        """X: (T, n, p) or (n, p) -> (T, n) decision values."""
        self._require_fit()
        X = torch.as_tensor(X, dtype=torch.float32, device=self.w_.device)
        if X.ndim == 2:
            X = X[None]
        return torch.einsum("tnp,tp->tn", X, self.w_) + self.b_[:, None]

    def predict(self, X) -> torch.Tensor:
        """Predicted labels in {-1, +1}: (T, n) for (T, n, p) inputs."""
        return torch.sign(self.decision(X))

    def risks(self, X_test, y_test) -> torch.Tensor:
        """(T,) per-task test risks (no node axis: the model is pooled)."""
        self._require_fit()
        y_test = torch.as_tensor(y_test, dtype=torch.float32,
                                 device=self.w_.device)
        if y_test.ndim == 1:
            y_test = y_test[None]
        g = self.decision(X_test)
        return (torch.sign(g) != torch.sign(y_test)).to(
            torch.float32).mean(-1)

    def global_risks(self, X_test, y_test) -> np.ndarray:
        """(T,) risks as numpy, already network-global (pooled model)."""
        return self.risks(X_test, y_test).cpu().numpy()

    def residuals(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """A centralized model is trivially in consensus."""
        z = torch.zeros((), dtype=torch.float32)
        return z, z
