"""Model facade + ``input_specs`` (twin of ``repro/models/model.py``).

``input_specs(cfg, shape)`` returns meta-device tensors (shape and dtype,
nothing allocated: the port's ``ShapeDtypeStruct``) for every input of
the step that the shape's ``step_kind`` selects; ``make_inputs`` makes
concrete ones from an explicit ``torch.Generator``.  A decode step's
cache is the stack's (``transformer.cache_spec``): KV or latent slots
with ``pos``, or a mamba2 layer's ``h`` and ``conv`` (the mamba leaves
of ``init_params``' tree: ``layers.<i>.mamba.in_proj``, ``conv_w``,
``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``norm``, ``out_proj``), or in
a zamba2 layer both (the shared block's tree is ``shared_attn``), and in
a whisper layer the cross block's ``xk``/``xv`` beside its KV slots.

Modality frontends are STUBS, as in the reference: VLM configs receive
pre-computed patch embeddings, audio configs pre-computed frame
embeddings (``frames``, (B, encoder_seq, d_model)), both with the
trunk's d_model.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch import device as device_lib
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.models import transformer
from repro_torch.models.layers import torch_dtype


def use_long_mode(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k decodes run dense archs in their windowed long-context
    variant."""
    return (shape.name == "long_500k" and cfg.long_context_ok
            and cfg.long_context_window > 0)


def max_positions(cfg: ModelConfig, shape: InputShape) -> int:
    # whisper's learned decoder position table must cover the workload
    return shape.seq_len if cfg.is_encoder_decoder else 0


def _generator(rng, dev: torch.device):
    """``rng`` as a generator on ``dev``: an int seeds a new one; a
    generator must already live there."""
    if isinstance(rng, torch.Generator):
        if rng.device.type != dev.type:
            raise ValueError(f"the generator is on {rng.device}, the "
                             f"tensors go to {dev}")
        return rng
    return torch.Generator(device=dev).manual_seed(int(rng))


def _max_seq(cfg: ModelConfig, shape: InputShape = None) -> int:
    """The ``max_seq`` the reference's ``init_params`` sizes whisper's
    decoder position table by: the workload's positions, or 4096 without
    a ``shape``."""
    return max_positions(cfg, shape) if shape is not None else 4096


def init_params(cfg: ModelConfig, rng, shape: InputShape = None,
                device=None) -> transformer.Transformer:
    """A randomly initialised ``Transformer`` on ``device`` (``None``
    means ``"cuda"``), drawn from ``rng`` (a ``torch.Generator`` on that
    device, or an int seed).  Only the encoder-decoder's ``pos_dec``
    depends on ``shape``: ``max_positions(cfg, shape)`` rows, or 4096
    without one, as in the reference."""
    dev = device_lib.resolve(device)
    return transformer.init_params(cfg, _generator(rng, dev), device=dev,
                                   max_seq=_max_seq(cfg, shape))


def param_specs(cfg: ModelConfig, shape: InputShape = None
                ) -> transformer.Transformer:
    """The model on the meta device: every parameter's shape and dtype,
    nothing allocated."""
    return transformer.init_params(cfg, None, device="meta",
                                   max_seq=_max_seq(cfg, shape))


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.frontend == "vision":
        return seq_len - cfg.num_prefix_tokens
    return seq_len


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: InputShape,
                compute_dtype=None) -> Dict[str, Any]:
    """Meta tensors for the selected step's data arguments; the decode
    step's ``cache_index`` is a Python int, given as ``int``."""
    B, S = shape.global_batch, shape.seq_len
    dtype = torch_dtype(compute_dtype or cfg.compute_dtype)
    i32 = torch.int32
    kind = shape.step_kind
    long_mode = use_long_mode(cfg, shape)

    if kind in ("train", "prefill"):
        St = _text_len(cfg, S)
        specs = {"tokens": _meta((B, St), i32)}
        if kind == "train":
            specs["targets"] = _meta((B, St), i32)
        if cfg.frontend == "vision":
            specs["vision_embeds"] = _meta(
                (B, cfg.num_prefix_tokens, cfg.d_model), dtype)
        if cfg.frontend == "audio":
            specs["frames"] = _meta((B, cfg.encoder_seq, cfg.d_model), dtype)
        return specs

    if kind == "decode":
        return {
            "tokens": _meta((B, 1), i32),
            "cache": transformer.cache_spec(cfg, B, S, dtype, long_mode),
            "cache_index": int,
        }
    raise ValueError(f"unknown step kind {kind!r}")


def make_inputs(cfg: ModelConfig, shape: InputShape, rng: torch.Generator,
                compute_dtype=None, device=None) -> Dict[str, Any]:
    """Concrete random inputs matching ``input_specs`` on ``device``
    (``None`` means ``"cuda"``), drawn from ``rng`` (a generator on that
    device, or an int seed)."""
    dev = device_lib.resolve(device)
    gen = _generator(rng, dev)
    specs = input_specs(cfg, shape, compute_dtype)
    dtype = torch_dtype(compute_dtype or cfg.compute_dtype)
    out: Dict[str, Any] = {}
    for name, s in specs.items():
        if name == "cache":
            out["cache"] = transformer.cache_init(
                cfg, shape.global_batch, shape.seq_len, dtype,
                use_long_mode(cfg, shape), device=dev)
        elif name == "cache_index":
            out["cache_index"] = 0
        elif s.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, s.shape,
                                      generator=gen, dtype=torch.int32,
                                      device=dev)
        else:
            out[name] = torch.randn(s.shape, generator=gen, dtype=s.dtype,
                                    device=dev)
    return out
