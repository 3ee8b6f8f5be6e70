"""The fused projected-gradient kernels (twin of ``repro/kernels/qp_step.py``).

- ``qp_pg_step`` launches ``csrc/qp_step.cu``, which replaces
  ``repro/kernels/qp_step.py:qp_pg_step_1d``: one step
  lam <- clip(lam + gamma (q - K lam), 0, hi) for a batch of problems.
- ``qp_pg_multi`` launches ``csrc/qp_multi.cu``, which replaces
  ``repro/kernels/qp_step.py:qp_pg_multi_1d``: the clipped warm start and
  all ``iters`` steps in one launch, f32 or bf16 K, with the optional
  ``zl = Z^T lam`` fold of the final iterate.

These are the wrappers: they check and shape the operands, launch, and
count the launches.  The plain versions are in ``ref``; ``ops`` picks one
of the two by the tensors' device.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of each kernel, counted where the wrapper launches it
COUNTS = {"qp_pg_step": 0, "qp_pg_multi": 0}
#: the multi solve's launch paths, by the number ``csrc/qp_multi.cu`` gives
MULTI_PATHS = ("block", "grid")


def _check_cuda_f32(**tensors):
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"the QP kernels take CUDA tensors; {name} is "
                             f"on {t.device} (the CPU path is ref)")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")


def qp_pg_step(lam: torch.Tensor, K: torch.Tensor, q: torch.Tensor,
               hi: torch.Tensor, gamma: torch.Tensor) -> torch.Tensor:
    """One fused PG step on the card.  lam/q/hi: (B, N), K: (B, N, N),
    gamma: (B,) -> (B, N)."""
    _check_cuda_f32(lam=lam, K=K, q=q, hi=hi, gamma=gamma)
    ext = build.extension()
    out = ext.qp_pg_step(lam.contiguous(), K.contiguous(), q.contiguous(),
                         hi.contiguous(), gamma.contiguous())
    COUNTS["qp_pg_step"] += 1
    return out


def qp_pg_multi(lam0: torch.Tensor, K: torch.Tensor, q: torch.Tensor,
                hi: torch.Tensor, gamma: torch.Tensor, *, iters: int,
                Z: Optional[torch.Tensor] = None, precision: str = "f32"):
    """The fused multi-iteration PG solve on the card.  lam0/q/hi:
    (B, N), K: (B, N, N), gamma: (B,), optional Z: (B, N, D).  Returns
    lam (B, N), or ``(lam, zl (B, D))`` with ``Z``.  ``precision="bf16"``
    converts an f32 K to bf16 here, on every call; a bf16 K (a ``Plan``'s,
    converted once) is taken as it is."""
    if precision not in ("f32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    _check_cuda_f32(lam0=lam0, q=q, hi=hi, gamma=gamma,
                    **({} if Z is None else {"Z": Z}))
    if K.device.type != "cuda":
        raise ValueError(f"K is on {K.device}; the QP kernels take CUDA "
                         f"tensors")
    if precision == "bf16":
        K = K.to(torch.bfloat16)
    elif K.dtype != torch.float32:
        raise TypeError(f"f32 mode takes a float32 K, got {K.dtype}")
    ext = build.extension()
    out = ext.qp_pg_multi(lam0.contiguous(), K.contiguous(), q.contiguous(),
                          hi.contiguous(), gamma.contiguous(),
                          None if Z is None else Z.contiguous(), int(iters))
    COUNTS["qp_pg_multi"] += 1
    return out[0] if Z is None else (out[0], out[1])


def qp_multi_shape(B: int, N: int, *, precision: str = "f32",
                   fold: bool = False) -> dict:
    """How ``qp_pg_multi`` launches for B problems of N rows on the
    current card: its path (``MULTI_PATHS``), CTAs, the most problems
    one CTA's rows touch and dynamic shared bytes per CTA."""
    path, blocks, per_cta, smem = build.extension().qp_multi_shape(
        precision == "bf16", fold, B, N)
    return {"path": MULTI_PATHS[path], "blocks": blocks,
            "problems_per_cta": per_cta, "smem_bytes": smem}
