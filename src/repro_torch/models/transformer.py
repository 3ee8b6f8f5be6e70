"""The decoder stack, dense and mixture-of-experts, with grouped-query or
multi-head latent attention, Mamba2's attention-free stack, Zamba2's
hybrid one and Whisper's encoder-decoder: prefill and ring-KV or
recurrent decode (twin of the serving half of
``repro/models/transformer.py``).

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
mamba block (``shared_attn_layers``).  An encoder-decoder config
(whisper) adds ``encoder`` (``layers``, a ``ModuleList`` of dense
``DecoderLayer`` without a cross block, and ``final_norm``), the learned
position tables ``pos_enc`` (encoder_seq, d) and ``pos_dec``
(max(max_seq, 1), d), and in every decoder layer ``ln_x`` and ``cross``
(``gqa_shapes``' leaves); it has no RoPE anywhere.  Weights keep the
reference's (d_in, d_out) layout and fp32; compute runs in
``cfg.compute_dtype``.  Modules and parameter dicts index alike
(``lp["attn"]``, ``"head" in params``), so every function here takes
either.

Public API (mirroring the reference's):
    init_params(cfg, rng, device, max_seq)         -> Transformer
    forward_train(params, batch, cfg, long_mode)    -> (logits, loss)
    prefill(params, batch, cfg, long_mode, ...)     -> (logits, cache)
    decode(params, batch, cache, idx, cfg, ...)     -> (logits, cache)
    cache_spec / cache_init(cfg, batch, ...)        -> cache (stacked)
    named_leaves(model)                             -> {name: parameter}

Caches are tensors stacked over the ``layers``, as the reference's scan
stacks them: ``k``/``v`` (L, B, Sc, K, hd), or under MLA the latent
``ckv`` (L, B, Sc, kv_lora_rank) and ``kr`` (L, B, Sc, rope), and ``pos``
(L, Sc); a mamba stack's state ``h`` (L, B, H, P, N) fp32 and conv window
``conv`` (L, B, w-1, conv_ch), the same size at every length (no
``pos``); a hybrid stack's both, in every layer (the reference's uniform
layout: an unflagged layer's ``k``/``v`` stay zeros and its ``pos`` -1);
an encoder-decoder layer's ``k``/``v``/``pos`` and the cross block's
``xk``/``xv`` (L, B, encoder_seq, K, hd), projected once at prefill and
read, never written, by decode; and ``cache["dense"]``, a list of one
per-layer dict of the same names per dense leading layer; ``decode``
writes the new key (or latent, or state and window) of every layer in
place.  Prefill and decode discard the MoE layers' aux loss, as the
reference's serving path does; ``forward_train`` adds every MoE layer's
to the loss.  ``forward_train`` runs the same blocks without a cache and
under autograd; ``cfg.remat`` (the reference's ``jax.checkpoint`` of
its scan's body) checkpoints each stacked layer, the shared block it
runs included, with a non-reentrant ``torch.utils.checkpoint``.  The
reference's scan over layers, ``lax.cond`` on the shared block's flag
(here a branch on the layer index) and ``constrain_activations`` have no
eager twin.

Two reference behaviours the port refuses with ``ValueError``
(ROADMAP queue 3): prefill over ``frames`` of another length than
``encoder_seq`` (the reference's cross cache then holds fewer rows, which
its ``_grow_cache`` pads with zero keys that decode attends to), and a
prompt longer than ``pos_dec`` (the reference broadcasts a one-row
table over every token).  Decode keeps the reference's clamp: a position
past the table reads its last row.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
    chunked_cross_entropy,
    cross_entropy,
    dense_init,
    embed_init,
    embed_tokens,
    lm_head,
    mlp_apply,
    mlp_shapes,
    rms_norm,
    torch_dtype,
)

def unsupported(cfg: ModelConfig):
    """The reason the stack cannot run ``cfg``, or None."""
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


def _attn_params(shapes: Dict[str, tuple], device) -> nn.ParameterDict:
    """A parameter per ``(shape, fan_in)`` leaf; those of fan_in 0 (the
    biases, the latent norms) start at zero."""
    return nn.ParameterDict({
        name: (_zeros(shape, device) if not fan else _empty(shape, device))
        for name, (shape, fan) in shapes.items()})


class DecoderLayer(_Indexed, nn.Module):
    """Pre-norm attention, then with ``cross`` a pre-norm cross attention
    over the encoder's output (``ln_x``, ``cross``), then a pre-norm MLP,
    or the MoE layer where the config has experts and the layer is not
    one of the dense leading ones; norms start at zero (the gemma
    convention: an offset from 1)."""

    def __init__(self, cfg: ModelConfig, device=None, dense: bool = False,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _zeros((d,), device)
        self.attn = _attn_params(_attn_shapes(cfg), device)
        if cross:
            self.ln_x = _zeros((d,), device)
            self.cross = _attn_params(attn.gqa_shapes(cfg), device)
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


class Encoder(_Indexed, nn.Module):
    """Whisper's bidirectional encoder: ``layers`` (dense layers without a
    cross block) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, dense=True)
                                    for _ in range(cfg.num_encoder_layers))
        self.final_norm = _zeros((cfg.d_model,), device)


class Transformer(_Indexed, nn.Module):
    """The model's parameters (uninitialised until :func:`init_params` or
    ``repro_torch.convert.lm_params_to_torch`` fills them).  ``max_seq``
    sizes an encoder-decoder's ``pos_dec`` (max(max_seq, 1) rows), as the
    reference's ``init_params`` does."""

    def __init__(self, cfg: ModelConfig, device=None, max_seq: int = 0):
        super().__init__()
        _require_supported(cfg)
        self.cfg = cfg
        V, d = cfg.vocab_size, cfg.d_model
        self.embed = _empty((V, d), device)
        self.final_norm = _zeros((d,), device)
        if not cfg.tie_embeddings:
            self.head = _empty((d, V), device)
        n_dense = _num_dense(cfg)
        cross = cfg.is_encoder_decoder
        if n_dense:
            self.dense_layers = nn.ModuleList(
                DecoderLayer(cfg, device, dense=True, cross=cross)
                for _ in range(n_dense))
        if _is_mamba(cfg):
            layer = functools.partial(MambaLayer, cfg, device)
        else:
            layer = functools.partial(DecoderLayer, cfg, device, cross=cross)
        self.layers = nn.ModuleList(layer()
                                    for _ in range(cfg.num_layers - n_dense))
        if _is_hybrid(cfg):
            # one tied block, reused at every flagged layer
            self.shared_attn = DecoderLayer(cfg, device, dense=True)
        if cfg.is_encoder_decoder:
            self.encoder = Encoder(cfg, device)
            # whisper: learned absolute positions
            self.pos_dec = _empty((max(max_seq, 1), d), device)
            self.pos_enc = _empty((cfg.encoder_seq, d), device)


#: the reference's subtrees whose leaves stack every layer's array along a
#: leading L axis
STACKED = (("layers",), ("encoder", "layers"))


def reference_path(name: str):
    """Where the port's parameter ``name`` sits in the reference's tree:
    its path (a list index in it an int) and the row of a stacked leaf,
    or None.  ``layers.<i>.<rest>`` (and ``encoder.layers.<i>.<rest>``) is
    row i of the stacked leaf ``layers.<rest>``; ``dense_layers.<i>`` is
    entry i of a list."""
    parts = name.split(".")
    for stack in STACKED:
        n = len(stack)
        if tuple(parts[:n]) == stack:
            return stack + tuple(parts[n + 1:]), int(parts[n])
    return tuple(int(p) if p.isdigit() else p for p in parts), None


def named_leaves(model) -> Dict[str, nn.Parameter]:
    """The model's parameters by name in the order of the reference's
    leaves (``jax.tree.leaves``: dict keys sorted, list entries in order),
    a stacked leaf's rows in layer order."""
    def key(item):
        path, row = reference_path(item[0])
        return path, -1 if row is None else row
    return dict(sorted(model.named_parameters(), key=key))


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
def _init_fans(params, shapes: Dict[str, tuple], rng) -> None:
    for name, (_, fan) in shapes.items():
        if fan:
            dense_init(params[name], fan, rng)


def init_params(cfg: ModelConfig, rng=None, device=None,
                max_seq: int = 0) -> Transformer:
    """A ``Transformer`` with the reference's init scheme, drawn from the
    ``torch.Generator`` ``rng`` (on ``device``; ``None`` draws from the
    default generator); ``max_seq`` sizes an encoder-decoder's
    ``pos_dec``.  ``device="meta"`` allocates nothing.  The draws are the
    port's own: to compute with the reference's weights, carry them
    across with ``repro_torch.convert.lm_params_to_torch``."""
    dev = torch.device("meta") if str(device) == "meta" else \
        device_lib.resolve(device)
    model = Transformer(cfg, dev, max_seq=max_seq)
    embed_init(model.embed, rng)
    if "head" in model:
        dense_init(model.head, cfg.d_model, rng)
    mlp_fans = mlp_shapes(cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    encoder = model.encoder.layers if "encoder" in model else ()
    for layer in (*getattr(model, "dense_layers", ()), *model.layers,
                  *([model.shared_attn] if "shared_attn" in model else ()),
                  *encoder):
        if "mamba" in layer:
            ssm_lib.mamba_init(layer.mamba, cfg, rng)
            continue
        _init_fans(layer.attn, _attn_shapes(cfg), rng)
        if "cross" in layer:
            _init_fans(layer.cross, attn.gqa_shapes(cfg), rng)
        if "moe" in layer:
            moe_lib.moe_init(layer.moe, cfg, rng)
        else:
            _init_fans(layer.mlp, mlp_fans, rng)
    if "encoder" in model:
        embed_init(model.pos_dec, rng)
        embed_init(model.pos_enc, rng)
    return model


# ===========================================================================
# the encoder and the embedding
# ===========================================================================
def _encode(params, frames, cfg: ModelConfig):
    """Whisper's encoder over stub frame embeddings (B, S_enc, d): the
    learned positions, then bidirectional layers without RoPE."""
    S = frames.shape[1]
    x = frames + params["pos_enc"][:S].to(frames.dtype)
    positions = torch.arange(S, device=x.device)
    encoder = params["encoder"]
    for lp in encoder["layers"]:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a = attn.gqa_apply(lp["attn"], h, positions=positions, window=0,
                           cfg=cfg, use_rope=False, causal=False)
        x = _mlp_block(lp, x + a, cfg)
    return rms_norm(x, encoder["final_norm"], cfg.norm_eps)


def _embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  dtype):
    """Token embedding + the vision prefix, or the encoder's output and
    the decoder's learned positions.  Returns (x, n_prefix, enc_out).
    ``frames`` must be (B, encoder_seq, d_model) and the prompt no longer
    than ``pos_dec``: either raises ``ValueError`` (module doc)."""
    tokens = batch["tokens"]
    scale = cfg.final_softcap > 0  # gemma-style embedding scaling
    x = embed_tokens(params["embed"], tokens, scale, dtype)
    enc_out = None
    n_prefix = 0
    if cfg.frontend == "vision":
        vis = batch["vision_embeds"].to(dtype)           # (B, P, d)
        x = torch.cat([vis, x], dim=1)
        n_prefix = vis.shape[1]
    elif cfg.frontend == "audio":
        frames = batch["frames"]
        want = (x.shape[0], cfg.encoder_seq, cfg.d_model)
        if tuple(frames.shape) != want:
            raise ValueError(f"{cfg.name}: frames of shape "
                             f"{tuple(frames.shape)}, the encoder takes "
                             f"{want}")
        enc_out = _encode(params, frames.to(dtype), cfg)
    if cfg.is_encoder_decoder:
        S, rows = x.shape[1], params["pos_dec"].shape[0]
        if S > rows:
            raise ValueError(f"{cfg.name}: a {S}-token prompt, the decoder's "
                             f"position table holds {rows} rows")
        x = x + params["pos_dec"][:S].to(dtype)
    return x, n_prefix, enc_out


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
    if cfg.is_encoder_decoder:
        # the cross block's K/V over the encoder's output, set at prefill
        kv = (batch, cfg.encoder_seq, cfg.num_kv_heads, cfg.head_dim)
        for name in ("xk", "xv"):
            per_layer[name] = torch.zeros(kv, dtype=torch_dtype(dtype),
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
# training: the full-sequence forward and the loss
# ===========================================================================
def _attn_block_train(lp, x, *, positions, window: int, cfg: ModelConfig,
                      enc_out=None):
    """A layer's attention (and cross attention) and its MLP or MoE half
    over the whole sequence, without a cache: (x, aux)."""
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, _ = attn.mla_apply(lp["attn"], h, positions=positions, cfg=cfg)
    else:
        a = attn.gqa_apply(lp["attn"], h, positions=positions, window=window,
                           cfg=cfg, use_rope=not cfg.is_encoder_decoder)
    x = x + a
    if enc_out is not None:
        k, v = attn.project_kv(lp["cross"], enc_out, cfg.num_kv_heads,
                               cfg.head_dim)
        x = _cross_block(lp, x, k, v, positions, cfg, cfg.attn_softcap)
    return _mlp_aux(lp, x, cfg)


def _layer_train(lp, x, shared, *, positions, window: int, shared_w: int,
                 cfg: ModelConfig, enc_out=None):
    """One stacked layer, then the shared block where ``shared`` is given
    (the layer is flagged): (x, aux), the reference's scan body."""
    if "mamba" in lp:
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        x, aux = x + ssm_lib.mamba_apply(lp["mamba"], h, cfg), 0.0
    else:
        x, aux = _attn_block_train(lp, x, positions=positions,
                                   window=window, cfg=cfg, enc_out=enc_out)
    if shared is not None:
        x, a2 = _attn_block_train(shared, x, positions=positions,
                                  window=shared_w, cfg=cfg)
        aux = aux + a2
    return x, aux


def _trunk(params, x, cfg: ModelConfig, long_mode: bool, enc_out=None):
    """Every layer over the hidden states x (the whole sequence): (x, the
    MoE layers' summed aux loss).  With ``cfg.remat`` each stacked layer
    is checkpointed; the dense leading layers are not, as in the
    reference, whose ``jax.checkpoint`` wraps the scan's body only."""
    positions = torch.arange(x.shape[1], device=x.device)
    aux = 0.0
    # the dense leading layers attend globally, as in prefill
    for lp in params["dense_layers"] if "dense_layers" in params else ():
        x, a = _attn_block_train(lp, x, positions=positions, window=0,
                                 cfg=cfg, enc_out=enc_out)
        aux = aux + a
    windows = layer_windows(cfg, long_mode)[_num_dense(cfg):]
    shared, flagged, shared_w = _shared_block(params, cfg, long_mode)
    layer = _layer_train
    if cfg.remat:
        # the layers draw no random numbers: no RNG state to replay
        layer = functools.partial(checkpoint, _layer_train,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
    for i, lp in enumerate(params["layers"]):
        x, a = layer(lp, x, shared if i in flagged else None,
                     positions=positions, window=windows[i],
                     shared_w=shared_w, cfg=cfg, enc_out=enc_out)
        aux = aux + a
    return x, aux


def forward_train(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                  long_mode: bool = False):
    """Full forward + loss.  batch: tokens (B,S), targets (B,S), optional
    vision_embeds / frames.  Returns (logits (B, S, V) fp32, or with
    ``cfg.chunked_ce`` the last position's (B, 1, V) only, and the mean
    token cross entropy plus the MoE layers' aux loss)."""
    _require_supported(cfg)
    dtype = torch_dtype(cfg.compute_dtype)
    x, n_prefix, enc_out = _embed_inputs(params, batch, cfg, dtype)
    x, aux = _trunk(params, x, cfg, long_mode, enc_out=enc_out)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if n_prefix:
        x = x[:, n_prefix:]
    head = _head(params)
    if cfg.chunked_ce:
        # never materialize the full (B,S,V) fp32 logits
        loss = chunked_cross_entropy(x, head, batch["targets"],
                                     cfg.final_softcap) + aux
        return lm_head(x[:, -1:], head, cfg.final_softcap), loss
    logits = lm_head(x, head, cfg.final_softcap)
    return logits, cross_entropy(logits, batch["targets"]) + aux


# ===========================================================================
# prefill
# ===========================================================================
def _attn_block_prefill(lp, x, *, positions, window: int, cfg: ModelConfig,
                        cache_len: int, enc_out=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    if cfg.use_mla:
        a, cache = attn.mla_prefill(lp["attn"], h, positions=positions,
                                    cfg=cfg, cache_len=cache_len)
    else:
        a, cache = attn.gqa_prefill(lp["attn"], h, positions=positions,
                                    window=window, cfg=cfg,
                                    cache_len=cache_len,
                                    use_rope=not cfg.is_encoder_decoder)
    x = x + a
    if enc_out is not None:
        # the cross K/V projected once: attended to here, cached for decode
        k, v = attn.project_kv(lp["cross"], enc_out, cfg.num_kv_heads,
                               cfg.head_dim)
        x = _cross_block(lp, x, k, v, positions, cfg, cfg.attn_softcap)
        cache["xk"], cache["xv"] = k, v
    return _mlp_block(lp, x, cfg), cache


def _cross_block(lp, x, k, v, positions, cfg: ModelConfig, cap: float):
    """The pre-norm cross attention over the encoder's K/V and its
    residual."""
    h = rms_norm(x, lp["ln_x"], cfg.norm_eps)
    return x + attn.gqa_cross(lp["cross"], h, k, v, positions=positions,
                              cfg=cfg, cap=cap)


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


def _mlp_aux(lp, x, cfg: ModelConfig):
    """The pre-norm MLP or MoE half of a layer and its residual, with the
    MoE layer's aux loss (0.0 for a dense MLP)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if "moe" in lp:
        m, aux = moe_lib.moe_apply(lp["moe"], h, cfg)
        return x + m, aux
    return x + mlp_apply(lp["mlp"], h, cfg.act, cfg.gated_mlp), 0.0


def _mlp_block(lp, x, cfg: ModelConfig):
    """``_mlp_aux`` with the aux loss discarded, as the reference's serving
    path does."""
    return _mlp_aux(lp, x, cfg)[0]


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
    x, _, enc_out = _embed_inputs(params, batch, cfg, dtype)
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
                                       cfg=cfg, cache_len=cache_len,
                                       enc_out=enc_out)
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
                                       cache_len=cache_len, enc_out=enc_out)
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
                                   window=window, cfg=cfg,
                                   use_rope=not cfg.is_encoder_decoder)
    x = x + a
    if "xk" in cache:
        # over the cached encoder K/V, uncapped as the reference's decode is
        pos = torch.full((1,), int(cache_index), device=x.device)
        x = _cross_block(lp, x, cache["xk"], cache["xv"], pos, cfg, 0.0)
    return _mlp_block(lp, x, cfg), cache


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
    if cfg.is_encoder_decoder:
        # past the table, its last row (the reference's clamp)
        rows = params["pos_dec"].shape[0]
        x = x + params["pos_dec"][min(int(cache_index), rows - 1)].to(dtype)
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
