"""Architecture registry (twin of ``repro/configs/__init__.py``).

``get_config(arch_id)`` / ``get_reduced_config(arch_id)`` resolve the ten
assigned architectures (plus the paper's own DTSVM experiment config via
``DTSVMConfig``).  ``ARCHS`` preserves the assignment ordering.
"""
from repro_torch.configs import (
    deepseek_v2_236b,
    gemma2_2b,
    gemma3_12b,
    internvl2_2b,
    mamba2_130m,
    phi3_5_moe_42b,
    qwen2_0_5b,
    qwen2_5_32b,
    whisper_small,
    zamba2_1_2b,
)
from repro_torch.configs.base import (
    SHAPES,
    DTSVMConfig,
    InputShape,
    ModelConfig,
    shape_applicable,
)

_MODULES = {
    "internvl2-2b": internvl2_2b,
    "gemma2-2b": gemma2_2b,
    "mamba2-130m": mamba2_130m,
    "gemma3-12b": gemma3_12b,
    "qwen2-0.5b": qwen2_0_5b,
    "zamba2-1.2b": zamba2_1_2b,
    "qwen2.5-32b": qwen2_5_32b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "whisper-small": whisper_small,
    "phi3.5-moe-42b-a6.6b": phi3_5_moe_42b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].config()


def get_reduced_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    return _MODULES[arch].reduced()


__all__ = [
    "ARCHS",
    "SHAPES",
    "DTSVMConfig",
    "InputShape",
    "ModelConfig",
    "get_config",
    "get_reduced_config",
    "shape_applicable",
]
