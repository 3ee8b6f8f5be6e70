"""The serving product (``csrc/rows.cu``): decision values of a batch of
rows against every hyperplane of a fitted network,

    G[i, k] = bf[k] + sum_j X[i, j] Wf[k, j],

each element summed in an order that depends on p alone: a group of
lanes per row, each lane a chain of fused multiply-adds over its chunks
of four features in ascending order, the lanes' sums met in a fixed xor
butterfly, the bias added last.  So a row's values are bitwise the same
whatever rows share its launch, wherever it lies in the batch and
wherever X starts.  It is no TPU kernel: the reference leaves ``X @ Wf.T + bf`` to XLA
(``repro/serve/model.py:gemm_rows``); the port needs the fixed order for
the reference's serving contract (``repro_torch.serve``).

This is the wrapper: it checks the operands, launches and counts the
launches.  The plain version is ``ref.gemm_rows``; ``ops`` picks one of
the two by the tensors' device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: launches of the kernel, counted where the wrapper launches it
COUNTS = {"gemm_rows": 0}


def gemm_rows(Wf: torch.Tensor, bf: torch.Tensor,
              X: torch.Tensor) -> torch.Tensor:
    """Wf (K, p), bf (K,), X (M, p), float32 on the card -> (M, K)."""
    for name, t in (("Wf", Wf), ("bf", bf), ("X", X)):
        if t.device.type != "cuda":
            raise ValueError(f"gemm_rows takes CUDA tensors; {name} is on "
                             f"{t.device} (the CPU path is ref)")
        if t.dtype != torch.float32:
            raise TypeError(f"gemm_rows is fp32; {name} is {t.dtype}")
    out = build.extension().gemm_rows(Wf.contiguous(), bf.contiguous(),
                                      X.contiguous())
    COUNTS["gemm_rows"] += 1
    return out
