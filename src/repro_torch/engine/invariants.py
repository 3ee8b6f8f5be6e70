"""Loop-invariant precomputation for the Prop.-1 ADMM iteration (twin of
``repro/engine/invariants.py``, its dense build).

Every quantity here depends only on the problem, never on the ADMM
state, so a fit computes it once:

    Z    (V,T,N,p+1)   label-signed augmented data  (Y X~, mask-zeroed)
    a    (V,T,p+1)     [I,I] U^{-1} [I,I]^T diagonal
    K    (V,T,N,N)     dual Hessian  Z diag(a) Z^T  (the Gram kernel)
    u    (V,T,2p+2)    diag(U_vt), eq. (10)
    ntp  (V,T)         coupling pair count
    nbr  (V,T)         active-neighbor count
    hi   (V,T,N)       QP box  box_scale * C * mask * active
    L    (V,T)         Gershgorin bound on K (the QP step is 1/L)

The streamed ``PlanBudget`` build and the K-less (factored) build wait
for the tiled Gram kernel (ROADMAP.md, "TPU kernels to port", item 1);
``PlanBudget`` is here so that a config dict means the same thing in
both packages.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dtsvm as core
from repro_torch.core import qp as qp_lib
from repro_torch.kernels import ops as kops


class PlanBudget(NamedTuple):
    """Memory budget for the invariant (Gram) build: the reference's
    fields.  Building under a budget is not ported yet."""
    max_elems: Optional[int] = None
    tile: Optional[Tuple[int, int]] = None


class PlanInvariants(NamedTuple):
    ntp: torch.Tensor      # (V, T)
    nbr: torch.Tensor      # (V, T)
    u: torch.Tensor        # (V, T, 2p+2)
    a: torch.Tensor        # (V, T, p+1)
    Z: torch.Tensor        # (V, T, N, p+1)
    K: Optional[torch.Tensor]   # (V, T, N, N)
    hi: torch.Tensor       # (V, T, N)
    L: torch.Tensor        # (V, T)


def _masks_part(prob: core.DTSVMProblem):
    """The active/couple-dependent pieces: counts, u, a, hi."""
    p = prob.X.shape[-1]
    ntp, nbr = core._counts(prob)
    u = core._u_diag(prob, ntp, nbr)
    a = 1.0 / u[..., : p + 1] + 1.0 / u[..., p + 1:]
    hi = prob.box_scale * prob.C * prob.mask * prob.active[..., None]
    return ntp, nbr, u, a, hi


def gram_and_lipschitz(Z: torch.Tensor, a: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual Hessian K = Z diag(a) Z^T (one batched Gram launch on
    the card) and its Gershgorin bound L."""
    K = kops.weighted_gram(Z, a)
    return K, qp_lib.gershgorin_lipschitz(K)


def compute_z(prob: core.DTSVMProblem) -> torch.Tensor:
    """The label-signed augmented data Z = Y [X, 1] (mask-zeroed)."""
    V, T, N, p = prob.X.shape
    ones = torch.ones((V, T, N, 1), dtype=torch.float32, device=prob.X.device)
    Xa = torch.cat([prob.X, ones], -1)
    return prob.y[..., None] * Xa * prob.mask[..., None]


def compute_invariants(prob: core.DTSVMProblem) -> PlanInvariants:
    """All loop-invariants of Prop. 1, from scratch (the dense build)."""
    ntp, nbr, u, a, hi = _masks_part(prob)
    Z = compute_z(prob)
    K, L = gram_and_lipschitz(Z, a)
    return PlanInvariants(ntp=ntp, nbr=nbr, u=u, a=a, Z=Z, K=K, hi=hi, L=L)
