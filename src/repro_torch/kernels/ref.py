"""Plain PyTorch versions of the hand kernels (twin of ``repro/kernels/ref.py``).

They define what the CUDA kernels compute.  The CPU path runs them, the
tests hold them against the reference package, and ``chip_smoke.py`` holds
each kernel against them on the card.  Nothing on the main path calls
them when the tensors are on the card.
"""
from __future__ import annotations

import torch


def weighted_gram(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K = Z diag(a) Z^T.  Z: (..., N, D), a: (..., D) -> (..., N, N).

    The dual Hessian of DTSVM's QP (6)."""
    return weighted_gram_rows(Z, a, Z)


def weighted_gram_rows(Zm: torch.Tensor, a: torch.Tensor,
                       Zn: torch.Tensor) -> torch.Tensor:
    """Rectangular block K = Zm diag(a) Zn^T.  Zm: (..., M, D),
    Zn: (..., N, D), a: (..., D) -> (..., M, N)."""
    return torch.matmul(Zm * a.to(Zm.dtype)[..., None, :],
                        Zn.transpose(-1, -2))


def gram_prescale(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Z (B, N, D) feature-major, unscaled and scaled by a (B, D):
    (2, B, D, N)."""
    return torch.stack([Z, Z * a[..., None, :]]).transpose(-1, -2) \
        .contiguous()


def _per_problem(gamma, lam: torch.Tensor) -> torch.Tensor:
    """A scalar or per-problem step size, leading-aligned against the
    batch dims of ``lam`` (..., N) and broadcast over the rest."""
    gamma = torch.as_tensor(gamma, dtype=lam.dtype, device=lam.device)
    return gamma.reshape(gamma.shape + (1,) * (lam.ndim - gamma.ndim))


def _box(x: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, hi) with a per-element upper bound."""
    return torch.minimum(torch.clamp_min(x, 0.0), hi)


def qp_pg_step(lam: torch.Tensor, K: torch.Tensor, q: torch.Tensor,
               hi: torch.Tensor, gamma) -> torch.Tensor:
    """One projected-gradient ascent step of the box QP:

        lam <- clip(lam + gamma * (q - K lam), 0, hi)

    lam/q/hi: (..., N), K: (..., N, N); ``gamma`` a scalar or one step
    per problem over a prefix of the batch dims."""
    grad = q - torch.matmul(K, lam[..., None])[..., 0]
    return _box(lam + _per_problem(gamma, lam) * grad, hi)


def qp_pg_multi(lam0: torch.Tensor, K: torch.Tensor, q: torch.Tensor,
                hi: torch.Tensor, gamma, *, iters: int, Z=None,
                precision: str = "f32"):
    """``iters`` steps of :func:`qp_pg_step` from the box-projected warm
    start.  ``precision="bf16"`` rounds both K and the iterate to bf16
    for the product and accumulates in f32 (the step and the projection
    stay f32).  With ``Z`` (..., N, D) it also returns ``zl = Z^T lam``
    of the final iterate: ``(lam, zl)``."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    lam = _box(lam0, hi)
    if precision == "f32":
        for _ in range(iters):
            lam = qp_pg_step(lam, K, q, hi, gamma)
    else:
        # bf16 x bf16 products are exact in f32: only the sum rounds
        K16 = K.to(torch.bfloat16).to(torch.float32)
        g = _per_problem(gamma, lam)
        for _ in range(iters):
            lam16 = lam.to(torch.bfloat16).to(torch.float32)
            Klam = torch.matmul(K16, lam16[..., None])[..., 0]
            lam = _box(lam + g * (q - Klam), hi)
    if Z is None:
        return lam
    # repro: noqa[raw-einsum-in-plan] — deliberate: the zl fold's plain twin is engine/plan.py's zl expression, so the plain fold is bitwise the unfolded plan path
    return lam, torch.einsum("...n,...nd->...d", lam, Z)


def gemm_rows(Wf: torch.Tensor, bf: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
    """Decision values of rows against every hyperplane: Wf (K, p),
    bf (K,), X (M, p) -> (M, K), ``bf + X @ Wf.T`` summed over the
    features one at a time, in order.  Every element is its own chain of
    elementwise operations, so a row's values are bitwise the same in any
    batch (a matrix product promises no such thing).  Each step rounds
    twice where the kernel's ``fmaf`` rounds once."""
    acc = bf.expand(X.shape[0], bf.shape[0]).clone()
    for j in range(X.shape[1]):
        acc = acc + X[:, j:j + 1] * Wf[:, j]
    return acc
