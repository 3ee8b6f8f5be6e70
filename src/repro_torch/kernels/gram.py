"""The weighted Gram kernels K = Z diag(a) Z^T (twin of
``repro/kernels/gram.py``).

``csrc/gram.cu`` holds them, over one tile routine:

- ``weighted_gram`` replaces ``repro/kernels/gram.py:weighted_gram_2d``:
  one launch builds the square Gram matrices of a whole batch of problems,
  one triangle computed and mirrored, so K is bitwise symmetric.
- ``weighted_gram_tiled`` replaces ``repro/kernels/gram.py:
  weighted_gram_tiled`` as the streamed build uses it: one launch builds
  the rows [s, s + M) of every problem's K, written into a given output
  view (the rows of a preallocated K, or one reused panel buffer), bitwise
  those rows of the square kernel's K.
- ``prescale`` lays Z out feature-major, unscaled and scaled by ``a``, for
  both: a (2, B, D, N) view of a scratch of ``prescale_elems`` floats
  (2·B·D·N4, N4 = N rounded up to 4), made once per build.

This module holds their wrappers: they check and shape the operands,
launch, and count the launches.  The plain versions are
``ref.weighted_gram`` / ``ref.weighted_gram_rows`` / ``ref.gram_prescale``;
``ops`` picks the kernels or the plain versions by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: launches of each kernel, counted where the wrapper launches it
COUNTS = {"weighted_gram": 0, "weighted_gram_tiled": 0, "gram_prescale": 0}


def _check_cuda_f32(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the Gram kernels take CUDA tensors; {name} is "
                             f"on {t.device} (the CPU path is ref)")
        if t.dtype != torch.float32:
            raise TypeError(f"the Gram kernels are fp32; {name} is "
                            f"{t.dtype}")


def prescale_elems(B: int, N: int, D: int) -> int:
    """Floats of :func:`prescale`'s scratch: 2·B·D·N4, N4 = N rounded up
    to 4.  A build on the card holds it beside K or its panels for the
    whole build; a binding ``PlanBudget.max_elems`` caps the panels only."""
    return 2 * B * D * (-(-N // 4) * 4)


def prescale(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """The Gram kernels' operands on the card.  Z: (B, N, D), a: (B, D) ->
    Zs (2, B, D, N), fp32: ``Zs[0, b, d, n] = Z[b, n, d]`` and
    ``Zs[1, b, d, n] = Z[b, n, d] * a[b, d]``, a view whose rows lie N4
    floats apart (N rounded up to 4, for 16-byte copies)."""
    _check_cuda_f32(Z=Z, a=a)
    Zs = build.extension().gram_prescale(Z.contiguous(), a.contiguous())
    COUNTS["gram_prescale"] += 1
    return Zs


def weighted_gram(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K = Z diag(a) Z^T on the card.  Z: (B, N, D), a: (B, D) ->
    (B, N, N), fp32, bitwise symmetric."""
    Zs = prescale(Z, a)
    K = build.extension().weighted_gram(Zs)
    COUNTS["weighted_gram"] += 1
    return K


def weighted_gram_tiled(Zs: torch.Tensor, row_start: int,
                        out: torch.Tensor) -> torch.Tensor:
    """Rows [row_start, row_start + M) of K = Z diag(a) Z^T on the card,
    written into ``out`` and returned.  Zs: :func:`prescale` of Z
    (B, N, D) and a, which carries N; out: a (B, M, N) fp32 view with unit
    column stride, e.g. ``K[:, s:s + M]`` of a preallocated (B, N, N) K.
    Bitwise those rows of :func:`weighted_gram`'s K."""
    _check_cuda_f32(Zs=Zs, out=out)
    M, N = out.shape[-2:]
    if N != Zs.shape[-1]:
        raise ValueError(f"out has {N} columns; Zs is of a {Zs.shape[-1]}"
                         f"-row Z")
    if not 0 <= row_start <= N - M:
        raise ValueError(f"rows [{row_start}, {row_start + M}) are not "
                         f"rows of a {N}-row K")
    build.extension().weighted_gram_tiled(Zs, int(row_start), out)
    COUNTS["weighted_gram_tiled"] += 1
    return out
