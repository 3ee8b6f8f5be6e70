"""The dense decoder family's serving path (twin of ``repro/models/``,
less ``moe.py`` and ``ssm.py``, which come with later slices)."""
from repro_torch.models import attention, layers, model, transformer  # noqa: F401
from repro_torch.models.model import (  # noqa: F401
    init_params,
    input_specs,
    make_inputs,
    param_specs,
    use_long_mode,
)
