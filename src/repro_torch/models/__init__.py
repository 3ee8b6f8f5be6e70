"""The decoder family's serving path, dense and mixture-of-experts, with
grouped-query or multi-head latent attention, and Mamba2's state-space
stack (twin of ``repro/models/``; the hybrid stack's shared attention and
the encoder come with later slices)."""
from repro_torch.models import (  # noqa: F401
    attention,
    layers,
    model,
    moe,
    ssm,
    transformer,
)
from repro_torch.models.model import (  # noqa: F401
    init_params,
    input_specs,
    make_inputs,
    param_specs,
    use_long_mode,
)
