"""Attention: grouped-query attention with sliding windows, soft-capping
and QKV bias, and DeepSeek-V2's multi-head latent attention (twin of
``repro/models/attention.py``).

Pure functions over parameter mappings.  Three entry points per
mechanism:

- ``gqa_apply`` / ``mla_apply``     : full-sequence self attention
- ``gqa_prefill`` / ``mla_prefill`` : the same, also returning the
  populated cache
- ``gqa_decode`` / ``mla_decode``   : one token against a cache, written
  in place

and, for the encoder-decoder (whisper), ``gqa_cross``: attention over
the encoder's K/V, which ``project_kv`` makes once at prefill and the
cache keeps for decode.

Windows are Python ints (0 = global).  KV caches are ring buffers with an
explicit per-slot position array; attention masks by position, never by
slot.  Long sequences (above ``_CHUNK_THRESHOLD``) take the online-softmax
schedule of ``_flash_sdpa`` so the (Sq, Sk) score matrix never
materialises, with the reference's thresholds.  The products are plain
``torch.einsum``/``matmul``: the reference's attention is plain ``jnp``
(no Pallas kernel), and ``F.scaled_dot_product_attention`` has neither
the softcap nor the per-slot position mask.

One deliberate difference from the reference: ``gqa_prefill`` puts each
kept key at slot ``pos mod cache_len`` (the reference keeps the last
``cache_len`` keys in slots ``0..cache_len-1``, which ``gqa_decode``'s
``pos mod cache_len`` write then corrupts unless the prompt length is a
multiple of the cache).  Prefill's logits and the cache's (pos -> k, v)
map are the reference's; only a decode after a prompt longer than the
cache changes, and there it becomes exact.

MLA caches the latent: ``ckv`` (B, Sc, kv_lora_rank) and the shared
rotary key ``kr`` (B, Sc, rope), 576 values a token at DeepSeek-V2's
widths where expanded keys and values would take H * (nope + rope + v).
``mla_apply`` / ``mla_prefill`` expand K and V per head and run the
GQA schedule with v's head dim (128) below q's and k's (192);
``mla_decode`` absorbs W_uk into the query and W_uv after the weights,
so it attends in the latent space.  The two forms are equal in exact
arithmetic only: in bf16 each is held to the reference's same form.
The absorbed decode keeps the op order XLA compiles the reference's to
(``_absorbed_scores``): each of the two score products rounded to the
compute dtype, their bf16 add done in fp32 and never rounded (the sum's
round trip through bf16 and back to fp32 is folded away), then divided
by sqrt(nope + rope).  MLA has no window, so its cache never wraps:
``mla_decode`` at a position past the cache raises (the reference's
``pos mod Sc`` write would drop the oldest token without a word).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, rms_norm, softcap

_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 512

NEG_INF = -2.0 ** 30


# ===========================================================================
# GQA
# ===========================================================================
def gqa_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Parameter name -> (shape, fan_in) in the reference's layout; the
    biases (fan_in 0) start at zero."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": ((d, H * hd), d), "wk": ((d, K * hd), d),
              "wv": ((d, K * hd), d), "wo": ((H * hd, d), H * hd)}
    if cfg.qkv_bias:
        shapes.update(bq=((H * hd,), 0), bk=((K * hd,), 0),
                      bv=((K * hd,), 0))
    return shapes


def _project_q(p, x, H, hd):
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    return q.reshape(*x.shape[:-1], H, hd)


def project_kv(p, x, K, hd):
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(*x.shape[:-1], K, hd)
    v = v.reshape(*x.shape[:-1], K, hd)
    return k, v


def _mask(q_pos, k_pos, window: int, causal: bool, k_valid=None):
    """(Sq, Sk) bool: key visible from query, by position."""
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= (q_pos[:, None] - k_pos[None, :]) < window
    if k_valid is not None:
        mask &= k_valid[None, :]
    return mask


def _sdpa(q, k, v, q_pos, k_pos, *, window: int, cap: float, scale: float,
          causal: bool, k_valid=None):
    """Grouped scaled-dot-product attention over one query block.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D); H = K * g.  q_pos: (Sq,),
    k_pos: (Sk,); window <= 0 is global.  Scores in fp32, softmax
    weights back in q's dtype before P.V.
    """
    B, Sq, H, D = q.shape
    K = k.shape[2]
    g = H // K
    qg = q.reshape(B, Sq, K, g, D)
    # the scores are the fp32 products of the compute-dtype operands (XLA
    # keeps a dot's product in fp32 where the next op converts to fp32)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores * scale
    scores = softcap(scores, cap)
    mask = _mask(q_pos, k_pos, window, causal, k_valid)
    scores = torch.where(mask[None, None, None], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Sq, H * v.shape[-1])


def _flash_sdpa(q, k, v, q_pos, k_pos, *, window: int, cap: float,
                scale: float, causal: bool, k_valid=None,
                q_chunk: int = _Q_CHUNK, kv_chunk: int = 2048):
    """Online-softmax (flash-style) attention: a loop over query blocks,
    and inside it over KV blocks with a running (max, denominator, acc);
    the (Sq, Sk) score matrix never materialises."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    g = H // K
    Dv = v.shape[-1]
    Cq = min(q_chunk, Sq)
    Ck = min(kv_chunk, Sk)
    if Sq % Cq or Sk % Ck:
        raise ValueError(f"blocks must divide the sequences: "
                         f"{(Sq, Cq, Sk, Ck)}")
    outs = []
    for i in range(0, Sq, Cq):
        qi = q[:, i:i + Cq].reshape(B, Cq, K, g, D)
        pi = q_pos[i:i + Cq]
        m = torch.full((B, K, g, Cq), -math.inf, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, K, g, Cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, K, g, Cq, Dv), dtype=torch.float32,
                          device=q.device)
        for j in range(0, Sk, Ck):
            kj, vj, pj = k[:, j:j + Ck], v[:, j:j + Ck], k_pos[j:j + Ck]
            valj = None if k_valid is None else k_valid[j:j + Ck]
            s = torch.einsum("bqkgd,bskd->bkgqs", qi, kj).float()
            s = softcap(s * scale, cap)
            mask = _mask(pi, pj, window, causal, valj)
            s = torch.where(mask[None, None, None], s, -math.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isinf(s), 0.0, p)
            alpha = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(qi.dtype), vj)
            acc = acc * alpha[..., None] + pv.float()
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]     # (B,K,g,Cq,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, Cq, H * Dv))
    return torch.cat(outs, dim=1).to(q.dtype)


def _chunked_sdpa(q, k, v, q_pos, k_pos, **kw):
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq * Sk <= _CHUNK_THRESHOLD ** 2 and Sq <= _CHUNK_THRESHOLD:
        return _sdpa(q, k, v, q_pos, k_pos, **kw)
    if Sq % _Q_CHUNK != 0:
        return _sdpa(q, k, v, q_pos, k_pos, **kw)
    kv_chunk = Sk if Sk % 2048 else 2048
    return _flash_sdpa(q, k, v, q_pos, k_pos, kv_chunk=kv_chunk, **kw)


def gqa_apply(p, x, *, positions, window: int, cfg: ModelConfig,
              use_rope: bool = True, causal: bool = True):
    """Self attention over a full sequence (bidirectional with
    ``causal=False``, as whisper's encoder)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _project_q(p, x, H, hd)
    k, v = project_kv(p, x, K, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _chunked_sdpa(
        q, k, v, positions, positions,
        window=window, cap=cfg.attn_softcap,
        scale=1.0 / math.sqrt(hd), causal=causal,
    )
    return out @ p["wo"].to(x.dtype)


def gqa_cross(p, x, k, v, *, positions, cfg: ModelConfig, cap: float):
    """Cross attention of x (B, S, d) at ``positions`` over the encoder's
    keys and values k, v (B, Se, K, hd) from :func:`project_kv`: no
    RoPE, no mask (every frame is visible), the scores soft-capped at
    ``cap``."""
    hd = cfg.head_dim
    q = _project_q(p, x, cfg.num_heads, hd)
    k_pos = torch.arange(k.shape[1], device=x.device)
    out = _chunked_sdpa(
        q, k.to(x.dtype), v.to(x.dtype), positions, k_pos,
        window=0, cap=cap, scale=1.0 / math.sqrt(hd), causal=False,
    )
    return out @ p["wo"].to(x.dtype)


def ring_layout(x: torch.Tensor, cache_len: int, dim: int, fill=0):
    """Seat the entries of ``x`` (positions 0..S-1 along ``dim``) in a
    ring of ``cache_len`` slots, each at slot ``pos mod cache_len``: the
    last ``cache_len`` entries where there are more, padded with ``fill``
    where there are fewer."""
    S = x.shape[dim]
    if cache_len >= S:
        pad = list(x.shape)
        pad[dim] = cache_len - S
        return torch.cat([x, torch.full(pad, fill, dtype=x.dtype,
                                         device=x.device)], dim=dim)
    kept = x.narrow(dim, S - cache_len, cache_len)
    return torch.roll(kept, shifts=(S - cache_len) % cache_len, dims=dim)


def gqa_prefill(p, x, *, positions, window: int, cfg: ModelConfig,
                cache_len: int, use_rope: bool = True):
    """Like gqa_apply but also returns the populated KV cache, each key at
    slot ``pos mod cache_len`` (see the module doc)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _project_q(p, x, H, hd)
    k, v = project_kv(p, x, K, hd)
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    out = _chunked_sdpa(
        q, k, v, positions, positions,
        window=window, cap=cfg.attn_softcap,
        scale=1.0 / math.sqrt(hd), causal=True,
    )
    cache = {"k": ring_layout(k, cache_len, 1),
             "v": ring_layout(v, cache_len, 1),
             "pos": ring_layout(positions.to(torch.int32), cache_len, 0,
                                fill=-1)}
    return out @ p["wo"].to(x.dtype), cache


def gqa_decode(p, x, cache, cache_index: int, *, window: int,
               cfg: ModelConfig, use_rope: bool = True):
    """One-token decode.  x: (B, 1, d).  cache k/v: (B, Sc, K, D),
    cache['pos']: (Sc,) slot positions (-1 = empty); cache_index: the
    current absolute position (a Python int).  The new key is written in
    place at slot ``cache_index mod Sc``; returns (out, cache)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cache_index = int(cache_index)
    Sc = cache["k"].shape[1]
    pos = torch.full((1,), cache_index, dtype=torch.int32, device=x.device)
    q = _project_q(p, x, H, hd)
    k1, v1 = project_kv(p, x, K, hd)
    if use_rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k1 = apply_rope(k1, pos, cfg.rope_theta)
    slot = cache_index % Sc
    ck, cv, cpos = cache["k"], cache["v"], cache["pos"]
    ck[:, slot] = k1[:, 0]
    cv[:, slot] = v1[:, 0]
    cpos[slot] = cache_index
    out = _sdpa(
        q, ck.to(q.dtype), cv.to(q.dtype), pos, cpos,
        window=window, cap=cfg.attn_softcap,
        scale=1.0 / math.sqrt(hd), causal=True, k_valid=cpos >= 0,
    )
    return out @ p["wo"].to(x.dtype), cache


def gqa_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """The cache's tensors on the meta device (shapes and dtypes only)."""
    return gqa_cache_init(cfg, batch, cache_len, dtype, device="meta")


def gqa_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device=None):
    K, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, K, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, K, hd), dtype=dtype,
                         device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32,
                          device=device),
    }


# ===========================================================================
# MLA (DeepSeek-V2 multi-head latent attention)
# ===========================================================================
def mla_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Parameter name -> (shape, fan_in) in the reference's layout; the
    latent norms (fan_in 0) start at zero."""
    d, H = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    return {"wdq": ((d, r_q), d), "q_ln": ((r_q,), 0),
            "wuq": ((r_q, H * (nope + rope)), r_q),
            "wdkv": ((d, r_kv), d), "kv_ln": ((r_kv,), 0),
            "wuk": ((r_kv, H * nope), r_kv), "wuv": ((r_kv, H * vh), r_kv),
            "wkr": ((d, rope), d), "wo": ((H * vh, d), H * vh)}


def _mla_q(p, x, cfg: ModelConfig, positions):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), RoPE applied."""
    H = cfg.num_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    cq = rms_norm(x @ p["wdq"].to(x.dtype), p["q_ln"], cfg.norm_eps)
    q = (cq @ p["wuq"].to(x.dtype)).reshape(*x.shape[:-1], H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _mla_latent(p, x, cfg: ModelConfig, positions):
    """(ckv (B, S, r_kv) normed, kr (B, S, rope) with RoPE applied)."""
    ckv = rms_norm(x @ p["wdkv"].to(x.dtype), p["kv_ln"], cfg.norm_eps)
    kr = (x @ p["wkr"].to(x.dtype))[..., None, :]             # (B,S,1,rope)
    kr = apply_rope(kr, positions, cfg.rope_theta)[..., 0, :]
    return ckv, kr


def mla_apply(p, x, *, positions, cfg: ModelConfig):
    """Full-sequence MLA with expanded K/V (the train/prefill form).
    Returns (out, {"ckv", "kr"}), the latents of every position."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    ckv, kr = _mla_latent(p, x, cfg, positions)
    k_nope = (ckv @ p["wuk"].to(x.dtype)).reshape(B, S, H, nope)
    v = (ckv @ p["wuv"].to(x.dtype)).reshape(B, S, H, vh)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr[:, :, None, :].expand(B, S, H, rope)], dim=-1)
    out = _chunked_sdpa(
        q, k, v, positions, positions,
        window=0, cap=0.0, scale=1.0 / math.sqrt(nope + rope), causal=True,
    )
    return out @ p["wo"].to(x.dtype), {"ckv": ckv, "kr": kr}


def mla_prefill(p, x, *, positions, cfg: ModelConfig, cache_len: int):
    """Like mla_apply but also returns the latent cache, position p at
    slot p (the cache holds the whole prompt: MLA has no window)."""
    S = x.shape[1]
    if cache_len < S:
        raise ValueError(f"mla_prefill: the cache holds {cache_len} slots, "
                         f"the prompt {S} tokens")
    out, lat = mla_apply(p, x, positions=positions, cfg=cfg)
    cache = {"ckv": ring_layout(lat["ckv"], cache_len, 1),
             "kr": ring_layout(lat["kr"], cache_len, 1),
             "pos": ring_layout(positions.to(torch.int32), cache_len, 0,
                                fill=-1)}
    return out, cache


def _absorbed_scores(q_lat, lat, q_rope, kr, denom: float):
    """The absorbed decode's fp32 scores (B, H, Sc): q_lat (B, H, r)
    against the latents lat (B, Sc, r), plus q_rope (B, H, rope) against
    kr (B, Sc, rope), all in the compute dtype.  Each product is rounded
    to that dtype and their sum taken in fp32, then divided by ``denom``:
    the op order XLA compiles the reference's bf16 add to (module doc)."""
    s_lat = torch.einsum("bhr,bsr->bhs", q_lat, lat)
    s_rope = torch.einsum("bhe,bse->bhs", q_rope, kr)
    return (s_lat.float() + s_rope.float()) / denom


def mla_decode(p, x, cache, cache_index: int, *, cfg: ModelConfig):
    """Absorbed-matrix one-token decode in the latent space.  x: (B, 1, d);
    cache ckv (B, Sc, r_kv), kr (B, Sc, rope), pos (Sc,) (-1 = empty);
    ``cache_index`` is the token's absolute position (a Python int).  The
    new latent is written in place at slot ``cache_index``, which must be
    below Sc (MLA attends to every earlier token; a full cache raises
    ``ValueError``); returns (out, cache)."""
    B = x.shape[0]
    H = cfg.num_heads
    nope, rope, vh = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank
    cache_index = int(cache_index)
    ckv, kr, cpos = cache["ckv"], cache["kr"], cache["pos"]
    Sc = ckv.shape[1]
    if not 0 <= cache_index < Sc:
        raise ValueError(f"mla_decode: position {cache_index} does not fit "
                         f"the cache's {Sc} slots")
    pos = torch.full((1,), cache_index, dtype=torch.int32, device=x.device)
    q_nope, q_rope = _mla_q(p, x, cfg, pos)                   # (B,1,H,·)
    ckv1, kr1 = _mla_latent(p, x, cfg, pos)                   # (B,1,r),(B,1,e)
    ckv[:, cache_index] = ckv1[:, 0]
    kr[:, cache_index] = kr1[:, 0]
    cpos[cache_index] = cache_index

    dt = x.dtype
    wuk = p["wuk"].to(dt).reshape(r_kv, H, nope)
    q_lat = torch.einsum("bhn,rhn->bhr", q_nope[:, 0], wuk)   # (B,H,r)
    lat = ckv.to(dt)
    scores = _absorbed_scores(q_lat, lat, q_rope[:, 0], kr.to(dt),
                              math.sqrt(nope + rope))
    valid = (cpos >= 0) & (cpos <= cache_index)
    scores = torch.where(valid[None, None, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhs,bsr->bhr", w, lat)                # (B,H,r)
    wuv = p["wuv"].to(dt).reshape(r_kv, H, vh)
    out = torch.einsum("bhr,rhv->bhv", ctx, wuv).reshape(B, 1, H * vh)
    return out @ p["wo"].to(dt), cache


def mla_cache_spec(cfg: ModelConfig, batch: int, cache_len: int, dtype):
    """The cache's tensors on the meta device (shapes and dtypes only)."""
    return mla_cache_init(cfg, batch, cache_len, dtype, device="meta")


def mla_cache_init(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device=None):
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "kr": torch.zeros((batch, cache_len, cfg.qk_rope_head_dim),
                          dtype=dtype, device=device),
        "pos": torch.full((cache_len,), -1, dtype=torch.int32,
                          device=device),
    }
