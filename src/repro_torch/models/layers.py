"""Common layers: norms, MLPs, rotary embeddings, initialisation (twin of
``repro/models/layers.py``).

Pure functions over tensors and parameter mappings (anything with
``p["name"]`` and ``"name" in p``: a dict, an ``nn.ParameterDict``, or a
module of :mod:`repro_torch.models.transformer`).  Parameters are fp32;
every function casts a weight to the activations' dtype where it uses it,
as the reference does.

The reference's ``mesh_axis_sizes`` and ``shard_hint`` have no twin: one
card has no mesh.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def torch_dtype(name) -> torch.dtype:
    """The torch dtype a config names (``"bfloat16"``, ``"float32"``)."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


# ---------------------------------------------------------------------------
# init (in place, from an explicit generator; the draws are the port's own,
# not the reference's: tests carry weights across with repro_torch.convert)
# ---------------------------------------------------------------------------
def _normal_(t: torch.Tensor, gen: Optional[torch.Generator]) -> torch.Tensor:
    if t.device.type == "meta":
        return t
    return t.normal_(0.0, 1.0, generator=gen)


def dense_init(t: torch.Tensor, fan_in: int,
               gen: Optional[torch.Generator]) -> torch.Tensor:
    """Scaled normal init (1/sqrt(fan_in)) of ``t`` in place."""
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    with torch.no_grad():
        return _normal_(t, gen).mul_(scale)


def embed_init(t: torch.Tensor, gen: Optional[torch.Generator]
               ) -> torch.Tensor:
    with torch.no_grad():
        return _normal_(t, gen).mul_(0.02)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in fp32 with the gemma convention: the stored scale is an
    offset from 1."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(dtype)


# ---------------------------------------------------------------------------
# activations / capping
# ---------------------------------------------------------------------------
def act_fn(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """gemma2-style logit soft-capping; no-op when cap == 0."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# gated / plain MLP
# ---------------------------------------------------------------------------
def mlp_shapes(d_model: int, d_ff: int, gated: bool) -> dict:
    """Parameter name -> (shape, fan_in), in the reference's layout
    (``x @ W``, W of shape (d_in, d_out))."""
    shapes = {"up": ((d_model, d_ff), d_model),
              "down": ((d_ff, d_model), d_ff)}
    if gated:
        shapes["gate"] = ((d_model, d_ff), d_model)
    return shapes


def mlp_apply(p, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    f = act_fn(act)
    up = x @ p["up"].to(x.dtype)
    if gated:
        up = f(x @ p["gate"].to(x.dtype)) * up
    else:
        up = f(up)
    return up @ p["down"].to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """fp32 frequencies, correctly rounded: the power is taken in fp64
    (torch's fp32 ``pow`` is off by an ulp at some exponents, which moves
    a key at position 2560 by ~1e-4)."""
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    return (1.0 / (theta ** expo.double())).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S).  The two
    halves of the head are rotated as a pair (concatenated, not
    interleaved), in fp32."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)             # (half,)
    ang = positions[..., None].float() * freqs                    # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                            # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / head
# ---------------------------------------------------------------------------
def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, scale: bool,
                 dtype) -> torch.Tensor:
    x = table[tokens].to(dtype)
    if scale:  # gemma convention: sqrt(d_model) embedding scaling
        # the factor rounded to ``dtype`` on the host, as the reference's
        # jnp.asarray(sqrt(d), dtype) is: no device scalar, no copy
        x = x * float(torch.tensor(math.sqrt(table.shape[-1]), dtype=dtype))
    return x


def lm_head(x: torch.Tensor, table: torch.Tensor, cap: float) -> torch.Tensor:
    """Logits in fp32, soft-capped; ``table`` is (d, V) (the tied
    embedding's transpose, or the untied head)."""
    logits = x @ table.to(x.dtype)
    return softcap(logits.float(), cap)


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (B,S,V) fp32, targets (B,S) int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _chunk_ce_sum(xc: torch.Tensor, head: torch.Tensor, tc: torch.Tensor,
                  cap: float) -> torch.Tensor:
    logits = lm_head(xc, head, cap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None].long())[..., 0]
    return torch.sum(logz - gold)


def chunked_cross_entropy(x: torch.Tensor, head: torch.Tensor,
                          targets: torch.Tensor, cap: float,
                          seq_chunk: int = 256) -> torch.Tensor:
    """CE without materializing the full (B,S,V) fp32 logits: a loop over
    sequence chunks, each chunk's logits recomputed in the backward
    (non-reentrant checkpoint, the reference's ``jax.checkpoint``).  The
    chunk halves until it divides S; at 1 or less the full loss is taken,
    as the reference's does."""
    B, S, d = x.shape
    C = seq_chunk
    while S % C != 0:
        C //= 2
        if C <= 1:
            return cross_entropy(lm_head(x, head, cap), targets)
    # the head cast once, not per chunk: the same bits the reference's
    # per-chunk cast gives
    head = head.to(x.dtype)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, C):
        total = total + checkpoint(_chunk_ce_sum, x[:, i:i + C], head,
                                   targets[:, i:i + C], cap,
                                   use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (B * S)
