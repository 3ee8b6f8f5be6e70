"""The decoder stack, dense and mixture-of-experts, with grouped-query or
multi-head latent attention, Mamba2's attention-free stack and Zamba2's
hybrid one: prefill and ring-KV or recurrent decode (twin of the dense,
MoE, MLA, mamba and hybrid halves of ``repro/models/transformer.py``).

``Transformer`` is an ``nn.Module`` holding the reference's parameter
tree: ``embed`` (V, d), ``final_norm``, ``head`` (d, V) where embeddings
are untied, ``dense_layers`` (a ``ModuleList``, the reference's list of
``first_k_dense`` leading dense-MLP layers of an MoE config) and
``layers``, a ``ModuleList`` of ``DecoderLayer`` (``ln1``, ``attn``,
``ln2``, and ``mlp``, or ``moe`` past ``first_k_dense`` in an MoE
config), or of ``MambaLayer`` (``ln1`` and ``mamba``, ``ssm.mamba_shapes``'
leaves; no MLP) where every stacked layer is a mamba layer (mamba2,
zamba2).  ``attn`` holds ``gqa_shapes``' leaves, or ``mla_shapes``' where
the config has ``use_mla`` (DeepSeek-V2).  A hybrid config (a
``MAMBA_SHARED_ATTN`` kind, zamba2) adds ``shared_attn``: one dense
``DecoderLayer`` whose weights every flagged layer reuses after its
mamba block (``shared_attn_layers``).  Weights keep the reference's
(d_in, d_out) layout and fp32; compute runs in ``cfg.compute_dtype``.  Modules and parameter dicts
index alike (``lp["attn"]``, ``"head" in params``), so every function
here takes either.

Public API (mirroring the reference's):
    init_params(cfg, rng, device)                  -> Transformer
    prefill(params, batch, cfg, long_mode, ...)     -> (logits, cache)
    decode(params, batch, cache, idx, cfg, ...)     -> (logits, cache)
    cache_spec / cache_init(cfg, batch, ...)        -> cache (stacked)

Caches are tensors stacked over the ``layers``, as the reference's scan
stacks them: ``k``/``v`` (L, B, Sc, K, hd), or under MLA the latent
``ckv`` (L, B, Sc, kv_lora_rank) and ``kr`` (L, B, Sc, rope), and ``pos``
(L, Sc); a mamba stack's state ``h`` (L, B, H, P, N) fp32 and conv window
``conv`` (L, B, w-1, conv_ch), the same size at every length (no
``pos``); a hybrid stack's both, in every layer (the reference's uniform
layout: an unflagged layer's ``k``/``v`` stay zeros and its ``pos`` -1);
and ``cache["dense"]``, a list of one per-layer dict of the
same names per dense leading layer; ``decode`` writes the new key (or
latent, or state and window) of every layer in place.  Prefill and
decode discard the MoE layers' aux loss, as the reference's serving path does.  The reference's scan over layers, ``lax.cond``
on the shared block's flag (here a branch on the layer index),
``constrain_activations`` and ``remat`` have no eager twin.  The encoder
raises ``NotImplementedError`` naming the slice of ROADMAP queue 1, item
9 that brings it; ``forward_train`` comes with the training slice.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn

from repro_torch import device as device_lib
from repro_torch.configs.base import (
    ATTN_GLOBAL,
    ATTN_LOCAL,
    MAMBA_SHARED_ATTN,
    ModelConfig,
)
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    embed_tokens,
    lm_head,
    mlp_apply,
    mlp_shapes,
    rms_norm,
    torch_dtype,
)

_SLICE = "is not ported yet: ROADMAP queue 1, item 9, the {} slice"


def unsupported(cfg: ModelConfig):
    """The reason the stack cannot run ``cfg``, or None."""
    if cfg.is_encoder_decoder or cfg.frontend == "audio":
        return "the encoder-decoder stack " + _SLICE.format(
            "encoder-decoder")
    scanned = cfg.layer_kinds()[_num_dense(cfg):]
    if len({k.startswith("mamba") for k in scanned}) > 1:
        return ("a stack that mixes mamba and attention layers has no "
                "twin: the reference's scan takes one kind of layer")
    return None


def _require_supported(cfg: ModelConfig) -> None:
    why = unsupported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: {why}")


# ===========================================================================
# modules
# ===========================================================================
class _Indexed:
    """``m["name"]`` and ``"name" in m`` over a module's parameters and
    submodules, so a module indexes as the reference's dict does."""

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _empty(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32,
                                    device=device))


def _zeros(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32,
                                    device=device))


class _Tree(_Indexed, nn.Module):
    """A nested parameter mapping: a parameter per ``(shape, fan_in)``
    leaf of ``shapes``, a submodule per nested dict (the MoE layer's
    ``shared`` experts)."""

    def __init__(self, shapes: dict, device=None):
        super().__init__()
        for name, spec in shapes.items():
            if isinstance(spec, dict):
                setattr(self, name, _Tree(spec, device))
            else:
                setattr(self, name, _empty(spec[0], device))


def _attn_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    return attn.mla_shapes(cfg) if cfg.use_mla else attn.gqa_shapes(cfg)


def _kv_cache_init(cfg: ModelConfig):
    return attn.mla_cache_init if cfg.use_mla else attn.gqa_cache_init


class DecoderLayer(_Indexed, nn.Module):
    """Pre-norm attention then a pre-norm MLP, or the MoE layer where the
    config has experts and the layer is not one of the dense leading
    ones; norms start at zero (the gemma convention: an offset from 1)."""

    def __init__(self, cfg: ModelConfig, device=None, dense: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _zeros((d,), device)
        self.attn = nn.ParameterDict({
            name: (_zeros(shape, device) if not fan else
                   _empty(shape, device))
            for name, (shape, fan) in _attn_shapes(cfg).items()})
        self.ln2 = _zeros((d,), device)
        if cfg.is_moe and not dense:
            self.moe = _Tree(moe_lib.moe_shapes(cfg), device)
        else:
            self.mlp = nn.ParameterDict({
                name: _empty(shape, device)
                for name, (shape, _) in mlp_shapes(d, cfg.d_ff,
                                                   cfg.gated_mlp).items()})


class MambaLayer(_Indexed, nn.Module):
    """A pre-norm Mamba2 block and its residual: ``ln1`` (zeros, an
    offset from 1) and the ``mamba`` leaves; no MLP, no ``ln2``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.ln1 = _zeros((cfg.d_model,), device)
        self.mamba = _Tree(ssm_lib.mamba_shapes(cfg), device)


class Transformer(_Indexed, nn.Module):
    """The decoder's parameters (uninitialised until
    :func:`init_params` or ``repro_torch.convert.lm_params_to_torch``
    fills them)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        _require_supported(cfg)
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        self.embed = _empty((V, d), device)
        self.final_norm = _zeros((d,), device)
        if not cfg.tie_embeddings:
            self.head = _empty((d, V), device)
        n_dense = _num_dense(cfg)
        if n_dense:
            self.dense_layers = nn.ModuleList(
                DecoderLayer(cfg, device, dense=True)
                for _ in range(n_dense))
        layer = MambaLayer if _is_mamba(cfg) else DecoderLayer
        self.layers = nn.ModuleList(layer(cfg, device)
                                    for _ in range(cfg.num_layers - n_dense))
        if _is_hybrid(cfg):
            # one tied block, reused at every flagged layer
            self.shared_attn = DecoderLayer(cfg, device, dense=True)


def _num_dense(cfg: ModelConfig) -> int:
    """The dense-MLP leading layers, held apart from the stacked ones."""
    return cfg.first_k_dense if cfg.is_moe else 0


def _is_mamba(cfg: ModelConfig) -> bool:
    """Whether the stacked layers are mamba layers (the reference's
    ``is_mamba``: ``unsupported`` refuses a stack that mixes kinds)."""
    return cfg.layer_kinds()[_num_dense(cfg)].startswith("mamba")


def _is_hybrid(cfg: ModelConfig) -> bool:
    """Whether the stack holds the shared attention block (the
    reference's ``has_shared``); a ``shared_attn_period`` alone does not
    add it."""
    return MAMBA_SHARED_ATTN in cfg.layer_kinds()


# ===========================================================================
# per-layer static attributes
# ===========================================================================
def layer_windows(cfg: ModelConfig, long_mode: bool) -> Tuple[int, ...]:
    """Per-layer attention window (0 = global), honoring long-context mode."""
    out = []
    for kind in cfg.layer_kinds():
        if kind == ATTN_LOCAL:
            out.append(cfg.sliding_window)
        elif kind == ATTN_GLOBAL:
            out.append(cfg.long_context_window if long_mode else 0)
        else:  # mamba layers: window unused
            out.append(0)
    return tuple(out)


def shared_attn_layers(cfg: ModelConfig) -> Tuple[int, ...]:
    """The layers the shared attention block follows (zamba2)."""
    return tuple(i for i, k in enumerate(cfg.layer_kinds())
                 if k == MAMBA_SHARED_ATTN)


def _shared_block(params, cfg: ModelConfig, long_mode: bool):
    """The shared block, the stacked layers it follows (indices into
    ``layers``) and its window: ``long_context_window`` in long mode,
    else global; (None, an empty set, 0) outside a hybrid stack."""
    if not _is_hybrid(cfg):
        return None, frozenset(), 0
    n_dense = _num_dense(cfg)
    flagged = frozenset(i - n_dense for i in shared_attn_layers(cfg))
    return (params["shared_attn"], flagged,
            cfg.long_context_window if long_mode else 0)


def _has_attention(cfg: ModelConfig) -> bool:
    kinds = cfg.layer_kinds()
    return any(not k.startswith("mamba") for k in kinds) or \
        MAMBA_SHARED_ATTN in kinds


def required_cache_len(cfg: ModelConfig, seq_len: int, long_mode: bool) -> int:
    """Uniform (stacked-over-layers) KV cache length."""
    if not _has_attention(cfg):
        return 0
    w = layer_windows(cfg, long_mode)
    attn_ws = [x for k, x in zip(cfg.layer_kinds(), w)
               if not k.startswith("mamba")]
    if cfg.shared_attn_period:
        attn_ws = [cfg.long_context_window if long_mode else 0]
    if any(x == 0 for x in attn_ws):
        return seq_len
    return min(seq_len, max(attn_ws))


# ===========================================================================
# parameter init
# ===========================================================================
def init_params(cfg: ModelConfig, rng=None, device=None) -> Transformer:
    """A ``Transformer`` with the reference's init scheme, drawn from the
    ``torch.Generator`` ``rng`` (on ``device``; ``None`` draws from the
    default generator).  ``device="meta"`` allocates nothing.  The draws
    are the port's own: to compute with the reference's weights, carry
    them across with ``repro_torch.convert.lm_params_to_torch``."""
    dev = torch.device("meta") if str(device) == "meta" else \
        device_lib.resolve(device)
    model = Transformer(cfg, dev)
    embed_init(model.embed, rng)
    if "head" in model:
        dense_init(model.head, cfg.d_model, rng)
    mlp_fans = mlp_shapes(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    for layer in (*getattr(model, "dense_layers", ()), *model.layers,
                  *([model.shared_attn] if "shared_attn" in model else ())):
        if "mamba" in layer:
            ssm_lib.mamba_init(layer.mamba, cfg, rng)
            continue
        for name, (_, fan) in _attn_shapes(cfg).items():
            if fan:
                dense_init(layer.attn[name], fan, rng)
        if "moe" in layer:
            moe_lib.moe_init(layer.moe, cfg, rng)
        else:
            for name, (_, fan) in mlp_fans.items():
                dense_init(layer.mlp[name], fan, rng)
    return model


# ===========================================================================
# embedding
# ===========================================================================
def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  dtype):
    """Token embedding + the vision prefix.  Returns (x, n_prefix,
    enc_out); ``enc_out`` is always None (the audio encoder comes with the
    encoder-decoder slice)."""
    tokens = batch["tokens"]
    scale = cfg.final_softcap > 0  # gemma-style embedding scaling
    x = embed_tokens(params["embed"], tokens, scale, dtype)
    n_prefix = 0
    if cfg.frontend == "vision":
        vis = batch["vision_embeds"].to(dtype)           # (B, P, d)
        x = torch.cat([vis, x], dim=1)
        n_prefix = vis.shape[1]
    elif cfg.frontend == "audio":
        raise NotImplementedError(f"{cfg.name}: the audio encoder "
                                  + _SLICE.format("encoder-decoder"))
    return x, n_prefix, None


def _head(params) -> torch.Tensor:
    return params["head"] if "head" in params else params["embed"].T


# ===========================================================================
# caches
# ===========================================================================
def cache_build(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                long_mode: bool, make: str, device=None) -> Dict:
    """The stacked cache for decode; ``seq_len`` = max positions.
    make = 'spec' (meta tensors, nothing allocated) | 'init'."""
    _require_supported(cfg)
    cache_len = required_cache_len(cfg, seq_len, long_mode)
    dev = torch.device("meta") if make == "spec" else \
        device_lib.resolve(device)
    kv_init = _kv_cache_init(cfg)
    if _is_mamba(cfg):
        per_layer = ssm_lib.mamba_cache_init(cfg, batch, torch_dtype(dtype),
                                             device=dev)
        if _is_hybrid(cfg):
            # the uniform layout: a KV slot in every layer, read only at
            # the flagged ones
            per_layer.update(kv_init(cfg, batch, cache_len,
                                     torch_dtype(dtype), device=dev))
    else:
        per_layer = kv_init(cfg, batch, cache_len, torch_dtype(dtype),
                            device=dev)
    n_dense = _num_dense(cfg)
    L = cfg.num_layers - n_dense
    cache = {"layers": {k: v[None].expand((L,) + v.shape).clone()
                        for k, v in per_layer.items()}}
    if n_dense:
        cache["dense"] = [{k: v.clone() for k, v in per_layer.items()}
                          for _ in range(n_dense)]
    return cache


cache_spec = functools.partial(cache_build, make="spec")
cache_init = functools.partial(cache_build, make="init")


# ===========================================================================
# prefill
# ===========================================================================
def _attn_block_prefill(lp, x, *, positions, window: int, cfg: ModelConfig,
                        cache_len: int):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = attn.mla_prefill(lp["attn"], h, positions=positions,
                                    cfg=cfg, cache_len=cache_len)
    else:
        a, cache = attn.gqa_prefill(lp["attn"], h, positions=positions,
                                    window=window, cfg=cfg,
                                    cache_len=cache_len)
    return _mlp_block(lp, x + a, cfg), cache


def _mamba_block(lp, x, cfg: ModelConfig, cache=None):
    """The pre-norm Mamba2 block and its residual: over the sequence with
    its cache (``cache`` None), or one recurrent step writing ``cache``
    in place."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cache is None:
        out, cache = ssm_lib.mamba_apply(lp["mamba"], h, cfg,
                                         return_cache=True)
    else:
        out, cache = ssm_lib.mamba_decode(lp["mamba"], h, cache, cfg)
    return x + out, cache


def _mlp_block(lp, x, cfg: ModelConfig):
    """The pre-norm MLP or MoE half of a layer; the MoE aux loss is
    discarded, as the reference's serving path does."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        m, _ = moe_lib.moe_apply(lp["moe"], h, cfg)
    else:
        m = mlp_apply(lp["mlp"], h, cfg.act, cfg.gated_mlp)
    return x + m


@torch.no_grad()
def prefill(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            long_mode: bool = False, min_cache_len: int = 0):
    """Process a prompt, return last-position logits (B, 1, V) fp32 and
    the populated cache.

    ``min_cache_len`` reserves ring-cache capacity beyond the prompt so
    the caller can decode continuation tokens without re-seating the
    cache."""
    _require_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    x, _, _ = _embed_inputs(params, batch, cfg, dtype)
    S = x.shape[1]
    cache_len = max(required_cache_len(cfg, S, long_mode), min_cache_len)
    positions = torch.arange(S, device=x.device)
    n_dense = _num_dense(cfg)
    # the dense leading layers attend globally (window 0), as the
    # reference's do whatever the config's pattern
    windows = layer_windows(cfg, long_mode)[n_dense:]
    cache = {}
    if n_dense:
        cache["dense"] = []
        for lp in params["dense_layers"]:
            x, c = _attn_block_prefill(lp, x, positions=positions, window=0,
                                       cfg=cfg, cache_len=cache_len)
            cache["dense"].append(c)
    shared, flagged, shared_w = _shared_block(params, cfg, long_mode)
    L = cfg.num_layers - n_dense
    stacked = {}
    for i, lp in enumerate(params["layers"]):
        if "mamba" in lp:
            x, c = _mamba_block(lp, x, cfg)
        else:
            x, c = _attn_block_prefill(lp, x, positions=positions,
                                       window=windows[i], cfg=cfg,
                                       cache_len=cache_len)
        if shared is not None:
            if i in flagged:
                x, kv = _attn_block_prefill(shared, x, positions=positions,
                                            window=shared_w, cfg=cfg,
                                            cache_len=cache_len)
            else:   # an empty slot, as the reference's cond writes
                kv = _kv_cache_init(cfg)(cfg, x.shape[0], cache_len,
                                         x.dtype, device=x.device)
            c = {**c, **kv}
        for name, t in c.items():
            if name not in stacked:
                stacked[name] = t.new_empty((L,) + t.shape)
            stacked[name][i] = t
    cache["layers"] = stacked
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = lm_head(x[:, -1:, :], _head(params), cfg.final_softcap)
    return logits, cache


# ===========================================================================
# decode
# ===========================================================================
def _attn_block_decode(lp, x, cache, cache_index: int, *, window: int,
                       cfg: ModelConfig):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = attn.mla_decode(lp["attn"], h, cache, cache_index,
                                   cfg=cfg)
    else:
        a, cache = attn.gqa_decode(lp["attn"], h, cache, cache_index,
                                   window=window, cfg=cfg)
    return _mlp_block(lp, x + a, cfg), cache


@torch.no_grad()
def decode(params, batch: Dict[str, torch.Tensor], cache: Dict,
           cache_index: int, cfg: ModelConfig, long_mode: bool = False):
    """One decode step.  batch['tokens']: (B, 1); ``cache_index`` is the
    token's absolute position.  Returns (logits (B, 1, V) fp32, cache),
    the cache updated in place."""
    _require_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    scale = cfg.final_softcap > 0
    x = embed_tokens(params["embed"], batch["tokens"], scale, dtype)
    n_dense = _num_dense(cfg)
    if n_dense:
        for lp, c in zip(params["dense_layers"], cache["dense"],
                         strict=True):
            x, _ = _attn_block_decode(lp, x, c, cache_index, window=0,
                                      cfg=cfg)
    windows = layer_windows(cfg, long_mode)[n_dense:]
    shared, flagged, shared_w = _shared_block(params, cfg, long_mode)
    layers = cache["layers"]
    for i, lp in enumerate(params["layers"]):
        c = {name: t[i] for name, t in layers.items()}
        if "mamba" in lp:
            x, _ = _mamba_block(lp, x, cfg, c)
        else:
            x, _ = _attn_block_decode(lp, x, c, cache_index,
                                      window=windows[i], cfg=cfg)
        if i in flagged:
            # the tied weights over this layer's own KV slot
            x, _ = _attn_block_decode(shared, x, c, cache_index,
                                      window=shared_w, cfg=cfg)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_head(x, _head(params), cfg.final_softcap), cache
