"""Dispatch between the hand kernels and their plain versions (twin of
``repro/kernels/ops.py``).

The choice is made by the device of the tensors, and by nothing else: on
a CUDA tensor the hand kernel runs (a failed build or launch raises), on
a CPU tensor the plain PyTorch version in ``ref`` runs.  There is no
switch.  Leading batch dims are flattened into the kernels' launch grid,
where the reference maps a one-problem kernel over them.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch

from repro_torch.kernels import gram as gram_kernel
from repro_torch.kernels import qp_step as qp_kernel
from repro_torch.kernels import ref
from repro_torch.kernels import rows as rows_kernel


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
    return {**gram_kernel.COUNTS, **qp_kernel.COUNTS, **rows_kernel.COUNTS}


def reset_launch_counts() -> None:
    for counts in (gram_kernel.COUNTS, qp_kernel.COUNTS, rows_kernel.COUNTS):
        for name in counts:
            counts[name] = 0


def broadcast_z(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Z expanded to ``a``'s extra leading batch dims (the sweep's
    shared-Z case: one (..., N, D) Z re-weighted by a stack of ``a``, or
    solved against a stack of duals lam (..., N))."""
    extra = (a.ndim - 1) - (Z.ndim - 2)
    if extra > 0:
        Z = Z.expand(a.shape[:-1] + Z.shape[-2:])
    return Z


def weighted_gram(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K = Z diag(a) Z^T over arbitrary leading batch dims (Z (..., N, D),
    a (..., D)).  Either may carry more leading dims than the other, which
    is broadcast up to them (a sweep's stack of ``a`` over one Z; CSVM's
    one ``a`` over a stack of tasks).  On the card one launch of the
    square kernel builds the whole batch."""
    Z = broadcast_z(Z, a)
    if a.ndim - 1 < Z.ndim - 2:
        a = a.expand(Z.shape[:-2] + a.shape[-1:])
    if not _on_card(Z, a):
        return ref.weighted_gram(Z, a)
    batch, (N, D) = Z.shape[:-2], Z.shape[-2:]
    K = gram_kernel.weighted_gram(Z.reshape(-1, N, D), a.reshape(-1, D))
    return K.reshape(batch + (N, N))


def weighted_gram_rows(Z: torch.Tensor, a: torch.Tensor, row0: int,
                       rows: int) -> torch.Tensor:
    """Rows [row0, row0 + rows) of K = Z diag(a) Z^T over leading batch
    dims: Z (..., N, D), a (..., D) -> (..., rows, N).  A sample-sharded
    rank's panel of K.

    The reference's ``weighted_gram_rows(Zm, a, Zn)`` takes any two
    operands, but every caller there passes a ``Zm`` that is rows of
    ``Zn`` (``repro/engine/invariants.py:166,198``,
    ``repro/api/backends.py:372``); the port takes Z and the row range, so
    a panel that is not rows of Z cannot be asked for (a range outside Z's
    N rows raises).  On the card Z is prescaled once and one launch of the
    tiled kernel builds the panel over the whole batch, bitwise those rows
    of :func:`weighted_gram`'s K."""
    Z = broadcast_z(Z, a)
    if a.ndim - 1 < Z.ndim - 2:
        a = a.expand(Z.shape[:-2] + a.shape[-1:])
    batch, (N, D) = Z.shape[:-2], Z.shape[-2:]
    rows = int(rows)
    out = torch.empty((math.prod(batch), rows, N), dtype=torch.float32,
                      device=Z.device)
    for _ in weighted_gram_panels(Z.reshape(-1, N, D), a.reshape(-1, D),
                                  [0], rows, out=out, row0=row0):
        pass
    return out.reshape(batch + (rows, N))


def weighted_gram_panels(Z: torch.Tensor, a: torch.Tensor, starts,
                         rows: int, *, out: Optional[torch.Tensor] = None,
                         row0: int = 0
                         ) -> Iterator[Tuple[int, torch.Tensor]]:
    """The row panels of K = Z diag(a) Z^T, one streamed step each of the
    large-n build.  Z: (B, N, D), a: (B, D).  Yields ``(start, panel)``
    for each ``start`` in ``starts``: panel = rows [row0 + start,
    row0 + start + rows) of K, (B, rows, N), written into
    ``out[:, start:start + rows]`` when ``out`` (B, M, N) is given (the
    rows [row0, row0 + M) of K), else into one (B, rows, N) buffer that
    the next panel overwrites.  On the card Z is prescaled once for all
    the panels and each panel is one launch of the tiled kernel over the
    batch, bitwise those rows of :func:`weighted_gram`."""
    card = _on_card(Z, a, out)
    B, N, _ = Z.shape
    row0 = int(row0)
    last = row0 + max(starts, default=0) + rows
    if row0 < 0 or last > N:
        raise ValueError(f"rows [{row0}, {last}) are not rows of a {N}-row "
                         f"Z: a panel of K is rows of Z diag(a) Z^T")
    buf = None if out is not None else torch.empty(
        (B, rows, N), dtype=torch.float32, device=Z.device)
    Zs = gram_kernel.prescale(Z, a) if card else None
    for start in starts:
        panel = buf if out is None else out[:, start:start + rows]
        k0 = row0 + start
        if card:
            gram_kernel.weighted_gram_tiled(Zs, k0, panel)
        else:
            panel.copy_(ref.weighted_gram_rows(Z[:, k0:k0 + rows], a, Z))
        yield start, panel


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
    sums, step and projection.  ``Z`` may lack leading batch dims of
    ``lam0`` (a sweep's Z, which its configs share): it is broadcast up to
    them."""
    if Z is not None:
        Z = broadcast_z(Z, lam0)
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


def gemm_rows(Wf: torch.Tensor, bf: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
    """Decision values of rows X (M, p) against every hyperplane Wf (K, p)
    with biases bf (K,): (M, K), each element in a fixed order, so a row's
    values do not depend on the batch it came in."""
    if not _on_card(Wf, bf, X):
        return ref.gemm_rows(Wf, bf, X)
    return rows_kernel.gemm_rows(Wf, bf, X)
