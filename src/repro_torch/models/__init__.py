"""The decoder family's serving path, dense and mixture-of-experts, with
grouped-query or multi-head latent attention, Mamba2's state-space stack
and Zamba2's hybrid one, whose mamba layers share one weight-tied
attention block (twin of ``repro/models/``; the encoder comes with a
later slice)."""
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
