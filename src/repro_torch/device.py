"""The device rule of the port's entry points.

``device=None`` means ``"cuda"``.  Where no card is present and the
caller has not asked for ``"cpu"``, the entry point raises: nothing ever
carries on on the CPU unasked.  On the card fp32 matrix products never
use TF32.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The ``torch.device`` an entry point runs on (see module doc)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        # the port's fp32 contract: no TF32 in any fp32 product
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu'; got {dev}")
    return dev
