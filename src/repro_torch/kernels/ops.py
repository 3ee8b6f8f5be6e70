"""Dispatch between the hand kernels and their plain versions (twin of
``repro/kernels/ops.py``).

The choice is made by the device of the tensors, and by nothing else: on
a CUDA tensor the hand kernel runs (a failed build or launch raises), on
a CPU tensor the plain PyTorch version in ``ref`` runs.  There is no
switch.  Leading batch dims are flattened into the kernels' launch grid,
where the reference maps a one-problem kernel over them.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import qp_step as qp_kernel
from repro_torch.kernels import ref


def _on_card(*tensors) -> bool:
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        return True
    raise ValueError(f"operands must all be on 'cuda' or all on 'cpu'; "
                     f"got {sorted(kinds)}")


def launch_counts() -> dict:
    """Launches of every hand kernel since the last reset."""
    return {**gram_kernel.COUNTS, **qp_kernel.COUNTS}


def reset_launch_counts() -> None:
    for counts in (gram_kernel.COUNTS, qp_kernel.COUNTS):
        for name in counts:
            counts[name] = 0


def broadcast_z(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Z expanded to ``a``'s extra leading batch dims (the sweep's
    shared-Z case: one (..., N, D) Z re-weighted by a stack of ``a``)."""
    extra = (a.ndim - 1) - (Z.ndim - 2)
    if extra > 0:
        Z = Z.expand(a.shape[:-1] + Z.shape[-2:])
    return Z


def weighted_gram(Z: torch.Tensor, a: torch.Tensor, *,
                  tile=None) -> torch.Tensor:
    """K = Z diag(a) Z^T over arbitrary leading batch dims (Z (..., N, D),
    a (..., D); ``a`` may carry more leading dims than Z, which is
    broadcast up).  With ``tile`` (a ``PlanBudget.tile``) the card runs
    the tiled kernel over the whole square, as the reference runs its
    tiled Pallas kernel; the result is bitwise the same."""
    Z = broadcast_z(Z, a)
    if not _on_card(Z, a):
        return ref.weighted_gram(Z, a)
    batch, (N, D) = Z.shape[:-2], Z.shape[-2:]
    Zf, af = Z.reshape(-1, N, D), a.reshape(-1, D)
    if tile is None:
        K = gram_kernel.weighted_gram(Zf, af)
    else:
        K = gram_kernel.weighted_gram_tiled(Zf, af, Zf)
    return K.reshape(batch + (N, N))


def weighted_gram_rows(Zm: torch.Tensor, a: torch.Tensor, Zn: torch.Tensor,
                       *, out: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The rectangular block K = Zm diag(a) Zn^T over leading batch dims:
    Zm (..., M, D), Zn (..., N, D), a (..., D) -> (..., M, N).  One
    streamed row panel of the large-n build.  ``out``, a (B, M, N) view
    with the batch dims flattened (e.g. rows of a preallocated K), takes
    the result in place and is returned."""
    if not _on_card(Zm, a, Zn, out):
        K = ref.weighted_gram_rows(Zm, a, Zn)
        if out is None:
            return K
        return out.copy_(K.reshape(out.shape))
    batch, (M, D), N = Zm.shape[:-2], Zm.shape[-2:], Zn.shape[-2]
    K = gram_kernel.weighted_gram_tiled(
        Zm.reshape(-1, M, D), a.reshape(-1, D), Zn.reshape(-1, N, D),
        out=out)
    return K if out is not None else K.reshape(batch + (M, N))


def _per_problem(gamma, batch, like: torch.Tensor) -> torch.Tensor:
    """A scalar or leading-aligned per-problem step as a flat (B,)."""
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=like.device)
    gamma = gamma.reshape(gamma.shape + (1,) * (len(batch) - gamma.ndim))
    return gamma.expand(batch).reshape(-1)


def qp_pg_step(lam, K, q, hi, gamma) -> torch.Tensor:
    """One fused PG step over arbitrary leading batch dims; ``gamma`` a
    scalar or one step per problem over a prefix of them."""
    if not _on_card(lam, K, q, hi):
        return ref.qp_pg_step(lam, K, q, hi, gamma)
    batch, N = lam.shape[:-1], lam.shape[-1]
    out = qp_kernel.qp_pg_step(
        lam.reshape(-1, N), K.reshape(-1, N, N), q.reshape(-1, N),
        hi.reshape(-1, N), _per_problem(gamma, batch, lam))
    return out.reshape(lam.shape)


def qp_pg_multi(lam0, K, q, hi, gamma, *, iters: int,
                Z: Optional[torch.Tensor] = None, precision: str = "f32"):
    """The fused multi-iteration PG solve over arbitrary leading batch
    dims.  Returns ``lam``, or ``(lam, zl)`` when ``Z`` (..., N, D) is
    given.  ``precision="bf16"``: bf16 K and iterate in the product, f32
    sums, step and projection."""
    if not _on_card(lam0, K, q, hi, Z):
        return ref.qp_pg_multi(lam0, K, q, hi, gamma, iters=iters, Z=Z,
                               precision=precision)
    batch, N = lam0.shape[:-1], lam0.shape[-1]
    out = qp_kernel.qp_pg_multi(
        lam0.reshape(-1, N), K.reshape(-1, N, N), q.reshape(-1, N),
        hi.reshape(-1, N), _per_problem(gamma, batch, lam0), iters=iters,
        Z=None if Z is None else Z.reshape((-1,) + Z.shape[-2:]),
        precision=precision)
    if Z is None:
        return out.reshape(lam0.shape)
    lam, zl = out
    return lam.reshape(lam0.shape), zl.reshape(batch + zl.shape[-1:])
