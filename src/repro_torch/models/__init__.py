"""The decoder family's serving path, dense and mixture-of-experts (twin
of ``repro/models/``, less the MLA half of ``attention.py`` and
``ssm.py``, which come with later slices)."""
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
