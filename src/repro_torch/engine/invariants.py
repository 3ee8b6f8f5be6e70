"""Loop-invariant precomputation for the Prop.-1 ADMM iteration (twin of
``repro/engine/invariants.py``).

Every quantity here depends only on the problem, never on the ADMM
state, so a fit computes it once:

    Z    (V,T,N,p+1)   label-signed augmented data  (Y X~, mask-zeroed)
    a    (V,T,p+1)     [I,I] U^{-1} [I,I]^T diagonal
    K    (V,T,N,N)     dual Hessian  Z diag(a) Z^T  (the Gram kernels)
    u    (V,T,2p+2)    diag(U_vt), eq. (10)
    ntp  (V,T)         coupling pair count
    nbr  (V,T)         active-neighbor count
    hi   (V,T,N)       QP box  box_scale * C * mask * active
    L    (V,T)         Gershgorin bound on K (the QP step is 1/L)

Large-n path: the dense build holds two K-sized buffers at once (K and
the |K| temporary of the Gershgorin pass).  Under a ``PlanBudget`` that
binds, the build streams K in row panels: each panel is one launch of the
tiled Gram kernel over the whole batch, written straight into its rows of
one preallocated K, and its |K| row sums are taken before the next panel,
so the transient workspace is one ``batch * chunk * N`` panel and its
|panel| temporary, plus, on the card, the prescaled Z that the Gram
kernels read (see ``PlanBudget``).  A budget that does not bind builds
K with the square kernel, as with no budget.  The reference's
``lax.fori_loop`` over chunks is a Python loop here.  A streamed K is
bitwise the dense K (on the card each panel element is
computed in the roles the square kernel gives it).  L is the same row
sums' maximum, but a panel's row sums may be reduced in another order
than the dense pass's, so it is held within rounding, not bitwise.
``materialize_k=False`` (the factored operator) keeps no K at all: the
panels are row-summed and discarded.  ``streamed_gram_panel`` also builds
a band of rows alone (``row0=``, ``rows=``): a sample-sharded rank's
panel of K (``repro_torch.dist.sample``).

``update_invariants`` is the incremental path behind ``Plan.replan``: a
change to ``active``/``couple`` recomputes the counts, u, a and the box,
and only the K slices whose ``a`` row changed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dtsvm as core
from repro_torch.core import qp as qp_lib
from repro_torch.kernels import ops as kops
from repro_torch.obs import spans as obs_spans

#: default row chunk of the K-less Lipschitz pass when no budget binds:
#: the transient panel is chunk*N elements, small against the O(N D)
#: factored working set.
DEFAULT_LIPSCHITZ_CHUNK = 512


class PlanBudget(NamedTuple):
    """Memory budget for the invariant (Gram) build: the reference's
    fields and meaning.

    max_elems: cap on the float32 elements of Gram workspace per streamed
    step; K streams in panels of ``chunk = max_elems // (batch * N)``
    rows (down to a multiple of 8, floor 8).  A budget that holds the
    whole build falls back to the dense path.  On the card the build
    also holds the Gram kernels' operands for its whole loop, Z
    prescaled: ``kernels.gram.prescale_elems(batch, N, D)`` = 2·batch·D·N4
    floats (N4 = N rounded up to 4) beside the max_elems of panel.  The
    chunk keeps the reference's integers, so that scratch is not charged
    to max_elems; where the chunk is below 2·D rows it is the larger.
    tile: ``(tile_m, tile_n)``.  Without ``max_elems``, ``tile_m`` is the
    row chunk.  The CUDA kernels keep their own CTA tile, so the tile
    never changes a result, and a tile that does not bind builds the
    square K with the square kernel.
    """
    max_elems: Optional[int] = None
    tile: Optional[Tuple[int, int]] = None

    def row_chunk(self, batch: int, n: int,
                  cols: Optional[int] = None) -> Optional[int]:
        """Rows of K streamed per step for a ``(batch, n, cols)`` build
        (``cols`` defaults to ``n``), or None when the budget does not
        bind (dense build)."""
        if self.max_elems is not None:
            per_row = max(int(batch) * int(cols if cols is not None
                                           else n), 1)
            chunk = max((int(self.max_elems) // per_row) // 8 * 8, 8)
        elif self.tile is not None:
            chunk = max(int(self.tile[0]) // 8 * 8, 8)
        else:
            return None
        return None if chunk >= n else chunk


class PlanInvariants(NamedTuple):
    ntp: torch.Tensor      # (V, T)
    nbr: torch.Tensor      # (V, T)
    u: torch.Tensor        # (V, T, 2p+2)
    a: torch.Tensor        # (V, T, p+1)
    Z: torch.Tensor        # (V, T, N, p+1)
    K: Optional[torch.Tensor]   # (V, T, N, N); None under the factored
    #                             operator (qp_engines.solve_factored_multi)
    hi: torch.Tensor       # (V, T, N)
    L: torch.Tensor        # (V, T)


def _masks_part(prob: core.DTSVMProblem,
                nbr_counts: Optional[torch.Tensor] = None):
    """The active/couple-dependent pieces: counts, u, a, hi
    (``nbr_counts``: precomputed (..., V, T) active-neighbor counts)."""
    p = prob.X.shape[-1]
    ntp, nbr = core._counts(prob, nbr_counts)
    u = core._u_diag(prob, ntp, nbr)
    a = 1.0 / u[..., : p + 1] + 1.0 / u[..., p + 1:]
    hi = prob.box_scale * prob.C * prob.mask * prob.active[..., None]
    return ntp, nbr, u, a, hi


def _flat_batch(Z: torch.Tensor, a: torch.Tensor):
    """Z broadcast up to ``a``'s batch, then both with the batch flattened:
    ``(batch, Z (B, N, D), a (B, D))``."""
    Z = kops.broadcast_z(Z, a)
    batch, (N, D) = Z.shape[:-2], Z.shape[-2:]
    return batch, Z.reshape(-1, N, D), a.reshape(-1, D)


def _row_starts(M: int, chunk: int):
    """The first row of each ``chunk``-row panel of M rows; the last
    panel's start clamps to ``M - chunk`` and recomputes a few rows (the
    same values rewritten)."""
    return [min(i * chunk, M - chunk) for i in range(-(-M // chunk))]


def _panel_rowsums(Z: torch.Tensor, a: torch.Tensor, chunk: int,
                   K: Optional[torch.Tensor] = None, *, row0: int = 0,
                   rows: Optional[int] = None) -> torch.Tensor:
    """Per-row |K| sums of the rows [row0, row0 + M) of K = Z diag(a) Z^T
    (M = ``rows``, default all N), built ``chunk`` rows at a time.
    Z: (B, N, D), a: (B, D) -> (B, M).  Each panel is one launch over the
    whole batch, written into its rows of ``K`` (B, M, N) when given, else
    into one reused (B, chunk, N) buffer and discarded."""
    B, N, _ = Z.shape
    M = N if rows is None else int(rows)
    rs = torch.empty((B, M), dtype=torch.float32, device=Z.device)
    for start, Kc in kops.weighted_gram_panels(
            Z, a, _row_starts(M, chunk), chunk, out=K, row0=row0):
        rs[:, start:start + chunk] = Kc.abs().sum(-1)
    return rs


def streamed_gram_panel(Z: torch.Tensor, a: torch.Tensor, chunk: int, *,
                        row0: int = 0, rows: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows [row0, row0 + M) of K = Z diag(a) Z^T (M = ``rows``,
    default all N: the square K) built ``chunk`` rows at a time, plus
    their per-row |K| sums from the same pass.

    Z: (..., N, D), a: (..., D) -> ``(K (..., M, N), rowsums (..., M))``.
    The reference's ``streamed_gram_panel(Zm, a, Zn, chunk, tile)`` is
    only ever called with ``Zm`` rows of ``Zn``; the port takes Z and the
    row range (see ``kernels.ops.weighted_gram_rows``).  Each panel is one
    launch over the whole batch into its rows of one preallocated panel,
    the last one's start clamped inside the M rows, so the live set is
    the panel plus one (batch, chunk, N) |panel|.  A sample-sharded rank
    streams its row panel this way.
    """
    batch, (N, D) = Z.shape[:-2], Z.shape[-2:]
    M = N if rows is None else int(rows)
    Zf = Z.reshape(-1, N, D)
    K = torch.empty((Zf.shape[0], M, N), dtype=torch.float32,
                    device=Z.device)
    rs = _panel_rowsums(Zf, a.reshape(-1, D), min(int(chunk), M), K,
                        row0=row0, rows=M)
    return K.reshape(batch + (M, N)), rs.reshape(batch + (M,))


def streamed_lipschitz(Z: torch.Tensor, a: torch.Tensor,
                       budget: Optional[PlanBudget] = None) -> torch.Tensor:
    """The Gershgorin bound L = max_i sum_j |K_ij| without keeping K: row
    panels are computed, row-summed and discarded.  ``budget`` sets the
    row chunk as for the materialized streamed build; without one (or
    when it does not bind) the chunk is :data:`DEFAULT_LIPSCHITZ_CHUNK`."""
    batch, Zf, af = _flat_batch(Z, a)
    B, N = Zf.shape[:2]
    chunk = budget.row_chunk(B, N) if budget is not None else None
    if chunk is None:
        chunk = DEFAULT_LIPSCHITZ_CHUNK
    rs = _panel_rowsums(Zf, af, min(chunk, N))
    return torch.clamp_min(rs.amax(-1), 1e-12).reshape(batch)


def gram_and_lipschitz(Z: torch.Tensor, a: torch.Tensor,
                       budget: Optional[PlanBudget] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual Hessian K = Z diag(a) Z^T and its Gershgorin bound L.

    Z: (..., N, D); ``a`` may carry extra leading batch dims (Z
    broadcasts up).  Without a binding ``budget``: one batched launch of
    the square Gram kernel, then ``gershgorin_lipschitz``.  With one: the
    streamed build.
    """
    if budget is not None:
        batch, Zf, af = _flat_batch(Z, a)
        chunk = budget.row_chunk(Zf.shape[0], Zf.shape[1])
        if chunk is not None:
            K, rs = streamed_gram_panel(Zf, af, chunk)
            L = torch.clamp_min(rs.amax(-1), 1e-12)
            return K.reshape(batch + K.shape[-2:]), L.reshape(batch)
    K = kops.weighted_gram(Z, a)
    return K, qp_lib.gershgorin_lipschitz(K)


def compute_z(prob: core.DTSVMProblem) -> torch.Tensor:
    """The label-signed augmented data Z = Y [X, 1] (mask-zeroed)."""
    V, T, N, p = prob.X.shape
    ones = torch.ones((V, T, N, 1), dtype=torch.float32, device=prob.X.device)
    Xa = torch.cat([prob.X, ones], -1)
    return prob.y[..., None] * Xa * prob.mask[..., None]


def compute_invariants(prob: core.DTSVMProblem, *,
                       nbr_counts: Optional[torch.Tensor] = None,
                       Z: Optional[torch.Tensor] = None,
                       budget: Optional[PlanBudget] = None,
                       materialize_k: bool = True) -> PlanInvariants:
    """All loop-invariants of Prop. 1, from scratch.

    ``nbr_counts`` gives the (V, T) active-neighbor counts precomputed (a
    rank of the ``"shard_map"`` backend holds one adjacency row and
    counts its neighbors against the global ``active`` table).  ``Z``
    may be passed in when the caller already holds it.  ``budget``
    streams the K build (see :func:`gram_and_lipschitz`).
    ``materialize_k=False`` is the factored-operator build: K stays
    ``None`` and only L is computed, through discarded row panels.  The
    build is an ``invariant_build`` span (host time only: the span never
    waits for the card).
    """
    with obs_spans.span("invariant_build", budgeted=budget is not None,
                        materialize_k=materialize_k):
        ntp, nbr, u, a, hi = _masks_part(prob, nbr_counts)
        if Z is None:
            Z = compute_z(prob)
        if materialize_k:
            K, L = gram_and_lipschitz(Z, a, budget)
        else:
            K, L = None, streamed_lipschitz(Z, a, budget)
        return PlanInvariants(ntp=ntp, nbr=nbr, u=u, a=a, Z=Z, K=K, hi=hi,
                              L=L)


def update_invariants(prob: core.DTSVMProblem, inv: PlanInvariants, *,
                      active=None, couple=None,
                      budget: Optional[PlanBudget] = None
                      ) -> Tuple[core.DTSVMProblem, PlanInvariants, int]:
    """Re-plan after a membership change.

    Returns ``(new_prob, new_inv, n_recomputed)``: ``n_recomputed`` (v,t)
    Gram slices were rebuilt (through ``budget``'s panels when it binds);
    the other ``V*T - n`` are the old K's, unchanged, since a slice
    depends only on Z, which membership never touches, and its own ``a``
    row.  The old invariants are left as they were.
    """
    dev = prob.X.device
    new_prob = prob
    if active is not None:
        new_prob = new_prob._replace(active=torch.as_tensor(
            active, dtype=torch.float32, device=dev))
    if couple is not None:
        new_prob = new_prob._replace(couple=torch.as_tensor(
            couple, dtype=torch.float32, device=dev))
    ntp, nbr, u, a, hi = _masks_part(new_prob)
    changed = (a != inv.a).any(-1)                             # (V, T)
    n = int(changed.sum())
    if n == 0:
        K, L = inv.K, inv.L
    elif inv.K is None:                      # factored plan: L-only rebuild
        K = None
        if n == changed.numel():
            L = streamed_lipschitz(inv.Z, a, budget)
        else:
            L = inv.L.clone()
            L[changed] = streamed_lipschitz(inv.Z[changed], a[changed],
                                            budget)
    elif n == changed.numel():
        K, L = gram_and_lipschitz(inv.Z, a, budget)
    else:
        K_sub, L_sub = gram_and_lipschitz(inv.Z[changed], a[changed],
                                          budget)               # (n, N, N)
        K, L = inv.K.clone(), inv.L.clone()
        K[changed] = K_sub
        L[changed] = L_sub
    new_inv = PlanInvariants(ntp=ntp, nbr=nbr, u=u, a=a, Z=inv.Z, K=K,
                             hi=hi, L=L)
    return new_prob, new_inv, n
