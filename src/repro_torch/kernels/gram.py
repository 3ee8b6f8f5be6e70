"""The weighted Gram kernels K = Zm diag(a) Zn^T (twin of
``repro/kernels/gram.py``).

``csrc/gram.cu`` holds both, over one tile body:

- ``weighted_gram`` replaces ``repro/kernels/gram.py:weighted_gram_2d``:
  one launch builds the square Gram matrices of a whole batch of problems.
- ``weighted_gram_tiled`` replaces ``repro/kernels/gram.py:
  weighted_gram_tiled``: one launch builds a rectangular row panel of
  every problem of a batch, written into a given output view (the rows of
  a preallocated K, in the streamed large-n build).  Its elements are
  bitwise the square kernel's.

This module holds their wrappers: they check and shape the operands,
launch, and count the launches.  The plain versions are
``ref.weighted_gram`` / ``ref.weighted_gram_rows``; ``ops`` picks one of
the two by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of each kernel, counted where the wrapper launches it
COUNTS = {"weighted_gram": 0, "weighted_gram_tiled": 0}


def _check_cuda_f32(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the Gram kernels take CUDA tensors; {name} is "
                             f"on {t.device} (the CPU path is ref)")
        if t.dtype != torch.float32:
            raise TypeError(f"the Gram kernels are fp32; {name} is "
                            f"{t.dtype}")


def weighted_gram(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K = Z diag(a) Z^T on the card.  Z: (B, N, D), a: (B, D) ->
    (B, N, N), fp32."""
    _check_cuda_f32(Z=Z, a=a)
    ext = build.extension()
    K = ext.weighted_gram(Z.contiguous(), a.contiguous())
    COUNTS["weighted_gram"] += 1
    return K


def weighted_gram_tiled(Zm: torch.Tensor, a: torch.Tensor, Zn: torch.Tensor,
                        out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K = Zm diag(a) Zn^T on the card.  Zm: (B, M, D), a: (B, D),
    Zn: (B, N, D) -> (B, M, N), fp32, written into ``out`` when given: a
    (B, M, N) view with unit column stride, e.g. ``K[:, s:s + M]`` of a
    preallocated (B, N, N) K."""
    _check_cuda_f32(Zm=Zm, a=a, Zn=Zn)
    if out is None:
        out = torch.empty((Zm.shape[0], Zm.shape[1], Zn.shape[1]),
                          dtype=torch.float32, device=Zm.device)
    else:
        _check_cuda_f32(out=out)
    ext = build.extension()
    ext.weighted_gram_tiled(Zm.contiguous(), a.contiguous(),
                            Zn.contiguous(), out)
    COUNTS["weighted_gram_tiled"] += 1
    return out
