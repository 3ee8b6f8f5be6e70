"""Optimizers (twin of ``repro/optim/``)."""
from repro_torch.optim.adamw import (  # noqa: F401
    adamw,
    apply_updates,
    clip_by_global_norm,
    clip_by_global_norm_,
    cosine_schedule,
    global_norm,
    sgd,
)
