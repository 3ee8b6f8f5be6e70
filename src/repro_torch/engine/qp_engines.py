"""Pluggable QP engines for the dual sub-problem (6) of Prop. 1 (twin of
``repro/engine/qp_engines.py``).

An engine solves the batched box QP

    maximize   -1/2 lam^T K lam + q^T lam,   0 <= lam <= hi

over leading batch dims (K: (..., N, N), the rest (..., N)) with a fixed
iteration count and an optional precomputed Lipschitz bound ``L`` (...):

    solve(K, q, hi, lam0=None, *, iters, L=None) -> lam

- ``"fista"``        accelerated projected gradient (plain tensor ops)
- ``"pg"``           projected-gradient ascent (plain tensor ops)
- ``"pallas_fused"`` the fused PG-step kernel (``csrc/qp_step.cu`` on the
                     card), launched ``iters`` times
- ``"pallas_fused_multi"`` the fused multi-iteration kernel
                     (``csrc/qp_multi.cu``): every iteration in one launch,
                     ``precision="bf16"``, and the ``zl = Z^T lam`` fold

The ``pallas_*`` names are the reference's, so that a config dict means
the same thing in both packages.  The step of the fused engines is
gamma = 1/L per problem.  ``solve_factored_multi``, outside the registry,
is ``qp_operator="factored"``'s solve: the same PG iteration with K
applied as Z (a (Z^T lam)), so no K exists.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.core import qp as qp_lib
from repro_torch.kernels import ops as kops

_REGISTRY: Dict[str, Callable] = {}


def register(name: str):
    """Register a QP engine under ``name`` (decorator)."""
    def deco(fn: Callable) -> Callable:
        _REGISTRY[name] = fn
        return fn
    return deco


def get(name: str) -> Callable:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown QP engine {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def names():
    return sorted(_REGISTRY)


def _prep(K, q, lam0, L):
    """Default the warm start and the Lipschitz bound."""
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    if L is None:
        L = qp_lib.gershgorin_lipschitz(K)
    return lam0, L


@register("fista")
def solve_fista(K, q, hi, lam0=None, *, iters: int,
                L: Optional[torch.Tensor] = None):
    lam0, L = _prep(K, q, lam0, L)
    return qp_lib.solve_box_qp_fista(K, q, hi, iters=iters, lam0=lam0, L=L)


@register("pg")
def solve_pg(K, q, hi, lam0=None, *, iters: int,
             L: Optional[torch.Tensor] = None):
    lam0, L = _prep(K, q, lam0, L)
    return qp_lib.solve_box_qp_pg(K, q, hi, iters=iters, lam0=lam0, L=L)


@register("pallas_fused")
def solve_pallas_fused(K, q, hi, lam0=None, *, iters: int,
                       L: Optional[torch.Tensor] = None):
    """Iterate the fused PG-step kernel: matvec, gradient step and box
    projection in one launch per step."""
    lam0, L = _prep(K, q, lam0, L)
    gamma = 1.0 / L                                  # (...,) per problem
    lam = torch.minimum(torch.clamp_min(lam0, 0.0), hi)
    for _ in range(iters):
        lam = kops.qp_pg_step(lam, K, q, hi, gamma)
    return lam


@register("pallas_fused_multi")
def solve_pallas_fused_multi(K, q, hi, lam0=None, *, iters: int,
                             L: Optional[torch.Tensor] = None,
                             precision: str = "f32", Z=None):
    """The fused multi-iteration solve: one launch runs every PG
    iteration.  ``precision="bf16"`` uses a bf16 K; with ``Z``
    (..., N, D) the return is ``(lam, zl)``, zl = Z^T lam of the final
    iterate folded into the same launch."""
    lam0, L = _prep(K, q, lam0, L)
    return kops.qp_pg_multi(lam0, K, q, hi, 1.0 / L, iters=iters, Z=Z,
                            precision=precision)


#: capability flags ``plan_step`` dispatches on: the engine understands
#: ``precision=`` and can fold the zl contraction via ``Z=``.
solve_pallas_fused_multi.supports_precision = True
solve_pallas_fused_multi.supports_fold = True


def solve_factored_multi(Z, a, q, hi, lam0=None, *, iters: int, L):
    """The low-rank PG solve: K = Z diag(a) Z^T has rank <= D << N, so
    each matvec is ``Z (a * (Z^T lam))``, two matrix products of O(N D)
    (Z: (..., N, D), a: (..., D)); K is never built.  ``L`` is mandatory:
    the invariant build streams it without keeping K.  Returns
    ``(lam, zl)``, zl = Z^T lam of the final iterate.  Not bitwise the
    materialized solve: the sums run in another order."""
    if lam0 is None:
        lam0 = torch.zeros_like(q)
    gamma = (1.0 / L)[..., None]                     # (..., 1) per problem
    lam = torch.minimum(torch.clamp_min(lam0, 0.0), hi)
    for _ in range(iters):
        zt = torch.matmul(lam[..., None, :], Z)                 # (..., 1, D)
        Klam = torch.matmul(Z, (a[..., None, :] * zt).transpose(-1, -2))
        lam = torch.minimum(torch.clamp_min(lam + gamma * (q - Klam[..., 0]),
                                            0.0), hi)
    zl = torch.matmul(lam[..., None, :], Z)[..., 0, :]
    return lam, zl
