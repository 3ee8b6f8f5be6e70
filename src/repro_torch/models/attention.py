"""Attention: grouped-query attention with sliding windows, soft-capping
and QKV bias (twin of the GQA half of ``repro/models/attention.py``).

Pure functions over parameter mappings.  Three entry points:

- ``gqa_apply``   : full-sequence self attention
- ``gqa_prefill`` : the same, also returning the populated KV cache
- ``gqa_decode``  : one token against a KV cache, written in place

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

The MLA half (DeepSeek-V2) comes with the MLA slice.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, softcap

_CHUNK_THRESHOLD = 2048
_Q_CHUNK = 512

NEG_INF = -2.0 ** 30

_MLA = ("multi-head latent attention (deepseek-v2) is not ported yet: "
        "ROADMAP queue 1, item 9, the MLA slice")


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


def _project_kv(p, x, K, hd):
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
              use_rope: bool = True, kv_x=None, causal: bool = True,
              kv_positions=None):
    """Self (or cross, via kv_x) attention over a full sequence."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _project_q(p, x, H, hd)
    k, v = _project_kv(p, kv_x if kv_x is not None else x, K, hd)
    k_pos = kv_positions if kv_positions is not None else positions
    if use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    out = _chunked_sdpa(
        q, k, v, positions, k_pos,
        window=window, cap=cfg.attn_softcap,
        scale=1.0 / math.sqrt(hd), causal=causal,
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
    k, v = _project_kv(p, x, K, hd)
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
    k1, v1 = _project_kv(p, x, K, hd)
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


def mla_init(*_a, **_k):
    raise NotImplementedError(_MLA)


mla_apply = mla_prefill = mla_decode = mla_cache_spec = mla_cache_init = \
    mla_init
