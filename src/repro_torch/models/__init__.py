"""The decoder family's serving path, dense and mixture-of-experts, with
grouped-query or multi-head latent attention (twin of ``repro/models/``,
less ``ssm.py``, which comes with a later slice)."""
from repro_torch.models import (  # noqa: F401
    attention,
    layers,
    model,
    moe,
    transformer,
)
from repro_torch.models.model import (  # noqa: F401
    init_params,
    input_specs,
    make_inputs,
    param_specs,
    use_long_mode,
)
