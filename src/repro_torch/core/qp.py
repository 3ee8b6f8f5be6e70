"""Box-constrained QPs, the dual sub-problem (6) of Prop. 1 (twin of
``repro/core/qp.py``).

    maximize   -1/2 lam^T K lam + q^T lam
    subject to 0 <= lam <= hi        (hi=0 rows encode padding/inactive data)

The solvers take a batch of problems at once: K (..., N, N), q/hi/lam
(..., N), L (...).  They run a fixed number of iterations, as the
reference's ``fori_loop``s do, here as Python loops of plain tensor ops.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def gershgorin_lipschitz(K: torch.Tensor) -> torch.Tensor:
    """Gershgorin upper bound on ||K||_2 for PSD K, batched:
    (..., N, N) -> (...)."""
    return torch.clamp_min(K.abs().sum(-1).amax(-1), 1e-12)


def _project(lam: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return torch.minimum(torch.clamp_min(lam, 0.0), hi)


def _matvec(K: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    return torch.matmul(K, lam[..., None])[..., 0]


def solve_box_qp_pg(K: torch.Tensor, q: torch.Tensor, hi: torch.Tensor,
                    iters: int = 200, lam0=None,
                    L: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Projected-gradient ascent with constant step 1/L (L: optional
    precomputed Gershgorin bound, one per problem)."""
    if L is None:
        L = gershgorin_lipschitz(K)
    step = (1.0 / L)[..., None]
    lam = torch.zeros_like(q) if lam0 is None else lam0
    lam = _project(lam, hi)
    for _ in range(iters):
        lam = _project(lam + step * (q - _matvec(K, lam)), hi)
    return lam


def solve_box_qp_fista(K: torch.Tensor, q: torch.Tensor, hi: torch.Tensor,
                       iters: int = 200, lam0=None,
                       L: Optional[torch.Tensor] = None) -> torch.Tensor:
    """FISTA-style accelerated projected gradient (monotone restart-free).
    The momentum sequence t_k does not depend on the data, so it is
    computed on the host in float32, as the reference carries it."""
    if L is None:
        L = gershgorin_lipschitz(K)
    step = (1.0 / L)[..., None]
    lam = torch.zeros_like(q) if lam0 is None else _project(lam0, hi)
    y = lam
    t = np.float32(1.0)
    for _ in range(iters):
        lam_new = _project(y + step * (q - _matvec(K, y)), hi)
        t_new = np.float32(0.5) * (np.float32(1.0) + np.sqrt(
            np.float32(1.0) + np.float32(4.0) * t * t))
        y = lam_new + float((t - np.float32(1.0)) / t_new) * (lam_new - lam)
        lam, t = lam_new, t_new
    return lam


def qp_objective(K: torch.Tensor, q: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """The dual objective -1/2 lam^T K lam + q^T lam per problem:
    K (..., N, N), q/lam (..., N) -> (...)."""
    return -0.5 * (lam * _matvec(K, lam)).sum(-1) + (q * lam).sum(-1)


def kkt_residual(K, q, hi, lam) -> torch.Tensor:
    """max |lam - proj(lam + grad)| per problem: zero iff lam is optimal."""
    grad = q - _matvec(K, lam)
    return (lam - _project(lam + grad, hi)).abs().amax(-1)
