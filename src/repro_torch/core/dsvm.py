"""DSVM, the consensus distributed SVM of Forero, Cano & Giannakis (2010),
the paper's single-task baseline [7] (twin of ``repro/core/dsvm.py``).

It is the T=1, no-task-coupling special case of DTSVM's Problem (4):
``couple = 0``, ``eps1`` huge (w0 forced to 0) and the box ``V * C``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import dtsvm as core

_EPS1_INF = 1e9


def dsvm_problem_fields(V: int) -> dict:
    """The DTSVMProblem overrides that specialize Prop. 1 to DSVM."""
    return dict(eps1=_EPS1_INF, eta1=0.0, box_scale=float(V),
                couple=np.zeros((V,), np.float32))


def make_dsvm_problem(X, y, mask=None, adj=None, *, C=0.01, eps2=1.0,
                      eta2=1.0, active=None,
                      device=None) -> core.DTSVMProblem:
    """X: (V, T, N, p); each task is trained independently (per-task
    DSVM), as the paper's figures use the baseline."""
    V = X.shape[0]
    return core.make_problem(X, y, mask, adj, C=C, eps2=eps2, eta2=eta2,
                             active=active, device=device,
                             **dsvm_problem_fields(V))


def run_dsvm(prob: core.DTSVMProblem, iters: int, qp_iters: int = 200,
             state: Optional[core.DTSVMState] = None, eval_fn=None):
    """``iters`` ADMM iterations of a DSVM problem: ``core.run_dtsvm`` on
    it (the baseline is a DTSVM problem with its own fields).  Returns
    ``(state, history)``."""
    return core.run_dtsvm(prob, iters, qp_iters, state=state,
                          eval_fn=eval_fn)
