"""The weighted Gram kernel K = Z diag(a) Z^T (twin of ``repro/kernels/gram.py``).

``csrc/gram.cu`` replaces ``repro/kernels/gram.py:weighted_gram_2d``: one
launch builds the Gram matrices of a whole batch of problems.  This
module is its wrapper: it checks and shapes the operands, launches, and
counts the launches.  The plain version is ``ref.weighted_gram``;
``ops.weighted_gram`` picks one of the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: launches of the kernel, counted where the wrapper launches it
COUNTS = {"weighted_gram": 0}


def weighted_gram(Z: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """K = Z diag(a) Z^T on the card.  Z: (B, N, D), a: (B, D) ->
    (B, N, N), fp32."""
    if Z.device.type != "cuda" or a.device.type != "cuda":
        raise ValueError("the Gram kernel takes CUDA tensors; "
                         "the CPU path is ref.weighted_gram")
    if Z.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"the Gram kernel is fp32; got {Z.dtype}, {a.dtype}")
    ext = build.extension()
    K = ext.weighted_gram(Z.contiguous(), a.contiguous())
    COUNTS["weighted_gram"] += 1
    return K
