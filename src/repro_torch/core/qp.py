"""Box-constrained QPs, the dual sub-problem (6) of Prop. 1 (twin of
``repro/core/qp.py``).

    maximize   -1/2 lam^T K lam + q^T lam
    subject to 0 <= lam <= hi        (hi=0 rows encode padding/inactive data)

The solvers take a batch of problems at once: K (..., N, N), q/hi/lam
(..., N), L (...).  They run a fixed number of iterations, as the
reference's ``fori_loop``s do, here as Python loops of plain tensor ops.
"""
from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

_HALF, _ONE, _FOUR = np.float32(0.5), np.float32(1.0), np.float32(4.0)


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
    """FISTA-style accelerated projected gradient (monotone restart-free),
    its momentum from :func:`fista_momentum`."""
    if L is None:
        L = gershgorin_lipschitz(K)
    step = (1.0 / L)[..., None]
    lam = torch.zeros_like(q) if lam0 is None else _project(lam0, hi)
    y = lam
    for coef in fista_momentum(iters):
        lam_new = _project(y + step * (q - _matvec(K, y)), hi)
        y = lam_new + coef * (lam_new - lam)
        lam = lam_new
    return lam


def fista_momentum(iters: int) -> Iterator[float]:
    """FISTA's momentum coefficients (t_k - 1) / t_{k+1}, k = 0 ..
    iters - 1, from t_0 = 1 and t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2.
    The sequence does not depend on the data, so it is computed on the
    host in float32, as the reference carries it."""
    t = _ONE
    for _ in range(iters):
        # repro: noqa[host-sync-in-hot-path] — np.sqrt of a host float32 scalar of a data-independent sequence; no tensor is read
        t_new = _HALF * (_ONE + np.sqrt(_ONE + _FOUR * t * t))
        # repro: noqa[host-sync-in-hot-path] — float() of the same host float32 scalars; no tensor is read
        yield float((t - _ONE) / t_new)
        t = t_new


def qp_objective(K: torch.Tensor, q: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """The dual objective -1/2 lam^T K lam + q^T lam per problem:
    K (..., N, N), q/lam (..., N) -> (...)."""
    return -0.5 * (lam * _matvec(K, lam)).sum(-1) + (q * lam).sum(-1)


def kkt_residual(K, q, hi, lam) -> torch.Tensor:
    """max |lam - proj(lam + grad)| per problem: zero iff lam is optimal."""
    grad = q - _matvec(K, lam)
    return (lam - _project(lam + grad, hi)).abs().amax(-1)
