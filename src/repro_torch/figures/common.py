"""Paper-regime data and the solver runners shared by the figures
(twin of ``benchmarks/common.py``).

All solver execution goes through ``repro_torch.api``.  A runner's timed
region starts after the data and the test set are on the device and
ends, on the card, in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch.api import CSVM, DSVM, DTSVM, SolverConfig, evaluate
from repro_torch.api import sweep_fit
from repro_torch.core import graph
from repro_torch.data import synthetic

# Paper Section IV defaults
C = 0.01
ETA1 = ETA2 = 1.0


def build(V, n_per_task, *, T=None, degree=0.8, graph_kind="random",
          n_test=1800, relatedness=0.9, noise=1.0, pos_frac=None, seed=0):
    """n_per_task: the TOTAL training samples of each task, split evenly
    over the nodes (the paper's style).  Returns (numpy data, adjacency),
    the reference's arrays exactly."""
    T = T or len(n_per_task)
    n_train = np.zeros((V, T), int)
    for t, n in enumerate(n_per_task):
        n_train[:, t] = synthetic.split_counts(n, V)
    data = synthetic.make_multitask_data(
        V=V, T=T, p=10, n_train=n_train, n_test=n_test,
        relatedness=relatedness, noise=noise, pos_frac=pos_frac, seed=seed)
    A = graph.make_graph(graph_kind, V, degree=degree, seed=seed)
    return data, A


def solver_config(*, iters, eps1=1.0, eps2=1.0, C_=C, qp_iters=100,
                  qp_solver="fista"):
    return SolverConfig(C=C_, eps1=eps1, eps2=eps2, eta1=ETA1, eta2=ETA2,
                        iters=iters, qp_iters=qp_iters, qp_solver=qp_solver)


def _on_device(data, dev):
    return [torch.as_tensor(data[k], dtype=torch.float32, device=dev)
            for k in ("X", "y", "mask")]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _timed_fit(solver, data, A, dev, *, active=None, couple=None,
               with_history=True, state=None):
    """Time the ADMM run only: the data and the test set go to the device
    before t0, so the wall stays comparable across runs.  One timed call,
    the build of the plan included (a fit pays it)."""
    V = data["X"].shape[0]
    X, y, mask = _on_device(data, dev)
    ev = evaluate.risk_eval_fn(V, data["X_test"], data["y_test"], dev) \
        if with_history else None
    _sync(dev)
    t0 = time.perf_counter()
    solver.fit(X, y, mask=mask, adj=A, active=active, couple=couple,
               state=state, eval_fn=ev, device=dev)
    _sync(dev)
    dt = time.perf_counter() - t0
    hist = evaluate.risk_curve(solver.history_)
    return solver.state_, hist, dt, solver.problem_


def run_dtsvm(data, A, iters, *, eps1=1.0, eps2=1.0, C_=C, qp_iters=100,
              active=None, couple=None, with_history=True, state=None,
              qp_solver="fista", device=None):
    solver = DTSVM(solver_config(iters=iters, eps1=eps1, eps2=eps2, C_=C_,
                                 qp_iters=qp_iters, qp_solver=qp_solver))
    return _timed_fit(solver, data, A, device_lib.resolve(device),
                      active=active, couple=couple,
                      with_history=with_history, state=state)


def run_dsvm(data, A, iters, *, eps2=1.0, C_=C, qp_iters=100,
             active=None, with_history=True, qp_solver="fista",
             device=None):
    solver = DSVM(solver_config(iters=iters, eps2=eps2, C_=C_,
                                qp_iters=qp_iters, qp_solver=qp_solver))
    return _timed_fit(solver, data, A, device_lib.resolve(device),
                      active=active, with_history=with_history)


def run_sweep(data, A, cfgs, iters, *, eps1=1.0, eps2=1.0, C_=C,
              qp_iters=100, chain=False, with_history=True,
              qp_solver="fista", device=None):
    """One batched fit of a whole config grid (``api.sweep_fit``).

    Returns ``(SweepResult, dt)``, dt the wall of the whole sweep: the
    problem's construction, the one shared invariant build and the
    batched ADMM run, what ``_timed_fit`` charges a serial fit."""
    dev = device_lib.resolve(device)
    X, y, mask = _on_device(data, dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = sweep_fit(
        X, y, cfgs, mask=mask, adj=A,
        base=solver_config(iters=iters, eps1=eps1, eps2=eps2, C_=C_,
                           qp_iters=qp_iters, qp_solver=qp_solver),
        X_test=data["X_test"] if with_history else None,
        y_test=data["y_test"] if with_history else None, chain=chain,
        device=dev)
    _sync(dev)
    return res, time.perf_counter() - t0


def run_csvm_per_task(data, *, C_scale=1.0, qp_iters=600, device=None):
    """Pooled centralized SVM per task: its (T,) test risks."""
    solver = CSVM(SolverConfig(C=C, qp_iters=qp_iters), C_scale=C_scale)
    solver.fit(data["X"], data["y"], mask=data["mask"], device=device)
    return [float(r) for r in solver.risks(data["X_test"], data["y_test"])]
