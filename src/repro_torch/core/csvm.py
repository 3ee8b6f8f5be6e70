"""CSVM, the centralized linear soft-margin SVM, the paper's [13] baseline
(twin of ``repro/core/csvm.py``).

Solved in the dual with the same box-QP machinery as DTSVM:

    max_lam  1^T lam - 1/2 lam^T (Y X~ diag(ainv) X~^T Y) lam,
    0 <= lam <= C,
    ainv = [1,...,1, 1/eps_b]

The unregularized bias of the textbook SVM puts an equality constraint
into the dual; the reference's penalty trick (a small ridge eps_b on b)
keeps the dual a pure box QP.  With eps_b = 1e-3 the bias column carries
a weight of 1000, so |K| reaches about 1e3; the FISTA step is 1/L, so
nothing in the solve changes scale.

``csvm_fit_tasks`` is one batched solve over the tasks: one Gram launch
on the card for all of them, then FISTA over the (T, N, N) K.
``csvm_fit`` is the same function on one task.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import qp as qp_lib
from repro_torch.kernels import ops as kops

_EPS_B = 1e-3


def csvm_fit_tasks(X: torch.Tensor, y: torch.Tensor, C: float,
                   mask: Optional[torch.Tensor] = None, qp_iters: int = 500,
                   eps_b: float = _EPS_B
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit one pooled SVM per task.  X: (T, N, p), y/mask: (T, N), fp32
    tensors on one device.  Returns (w (T, p), b (T,))."""
    T, N, p = X.shape
    if mask is None:
        mask = torch.ones((T, N), dtype=torch.float32, device=X.device)
    ones = torch.ones((T, N, 1), dtype=torch.float32, device=X.device)
    Z = y[..., None] * torch.cat([X, ones], -1) * mask[..., None]
    ainv = torch.ones((p + 1,), dtype=torch.float32, device=X.device)
    ainv[p] = 1.0 / eps_b
    K = kops.weighted_gram(Z, ainv)          # one a, broadcast over tasks
    lam = qp_lib.solve_box_qp_fista(K, mask, C * mask, iters=qp_iters)
    # diag(ainv) Z^T lam, per task
    w_aug = torch.matmul(lam[..., None, :], Z * ainv)[..., 0, :]
    return w_aug[:, :p], w_aug[:, p]


def csvm_fit(X: torch.Tensor, y: torch.Tensor, C: float,
             mask: Optional[torch.Tensor] = None, qp_iters: int = 500,
             eps_b: float = _EPS_B) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit on pooled data.  X: (N, p), y/mask: (N,).  Returns (w, b)."""
    w, b = csvm_fit_tasks(X[None], y[None], C,
                          None if mask is None else mask[None],
                          qp_iters=qp_iters, eps_b=eps_b)
    return w[0], b[0]


def csvm_decision(w: torch.Tensor, b: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    return X @ w + b


def csvm_risk(w, b, X, y) -> torch.Tensor:
    g = csvm_decision(w, b, X)
    return (torch.sign(g) != torch.sign(y)).to(torch.float32).mean()
