"""Step functions: prefill and decode (twin of the serving half of
``repro/train/steps.py``).

The training steps (allreduce and ADMM consensus) come with the training
slice (ROADMAP queue 1, item 9); ``make_step`` raises for them.  The
steps are plain functions: eager PyTorch has no ``jit`` to wrap them in.
"""
from __future__ import annotations

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import model as model_lib
from repro_torch.models import transformer

_TRAIN = ("the training steps are not ported yet: ROADMAP queue 1, item 9, "
          "the training slice")


def make_train_step(cfg: ModelConfig, **kw):
    raise NotImplementedError(_TRAIN)


def make_prefill_step(cfg: ModelConfig, long_mode: bool = False):
    def prefill_step(params, batch):
        return transformer.prefill(params, batch, cfg, long_mode=long_mode)
    return prefill_step


def make_decode_step(cfg: ModelConfig, long_mode: bool = False):
    def decode_step(params, tokens, cache, cache_index):
        logits, new_cache = transformer.decode(
            params, {"tokens": tokens}, cache, cache_index, cfg,
            long_mode=long_mode)
        return logits, new_cache, cache_index + 1
    return decode_step


def make_step(cfg: ModelConfig, shape: InputShape, **kw):
    """Step factory keyed on the workload's step kind."""
    long_mode = model_lib.use_long_mode(cfg, shape)
    if shape.step_kind == "train":
        return make_train_step(cfg, long_mode=long_mode, **kw)
    if shape.step_kind == "prefill":
        return make_prefill_step(cfg, long_mode=long_mode)
    if shape.step_kind == "decode":
        return make_decode_step(cfg, long_mode=long_mode)
    raise ValueError(shape.step_kind)
