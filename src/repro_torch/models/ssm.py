"""Mamba2 (SSD, state-space duality) block (twin of
``repro/models/ssm.py``).  [arXiv:2405.21060]

Prefill runs the chunked SSD block decomposition: quadratic within a
chunk, a linear recurrence across chunks (a Python loop over the chunks
in place of the reference's ``lax.scan``, emitting each chunk's
*incoming* state as the scan's ``step`` does).  Decode is the O(1)
recurrent step, writing the state ``h`` and the conv window ``conv`` in
place.  Pure functions over parameter mappings, as
:mod:`repro_torch.models.attention`.  Plain PyTorch: the reference's SSD
is plain ``jnp``, no Pallas kernel.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim SSM heads of
head_dim = P channels and d_state = N; B and C are shared per group
(ngroups = G; head h reads group h // (H / G), as ``jnp.repeat`` lays
them out).  The reference's three-operand einsums are pairwise products
in the order XLA compiles them to (the elementwise factor first where it
multiplies the contracted operand), so no path depends on
``opt_einsum``.

bf16 follows the op order XLA compiles the reference's to on the CPU
(read from its HLO; ROADMAP queue 3):

- ``_silu``: ``x * (1 / (1 + exp(-x)))``, each of the four ops rounded
  to the compute dtype (``jax.nn.silu`` expands so); ``F.silu`` rounds
  once.
- ``_causal_conv`` (prefill): each of the w products and each add
  rounded.  ``_conv_step`` (decode): the reference's ``einsum`` is a
  dot, so its w products are summed in fp32 and rounded once, then the
  bias added in the compute dtype.  The two forms differ in bf16 by
  design; each is held to the reference's same form.
- ``_gated_norm``: the gate product ``y * silu(z)`` is taken in fp32 and
  never rounded before the fp32 RMSNorm (XLA folds the round trip).
- ``dtx = x * dt`` rounds dt to the compute dtype, then the product; the
  intra-chunk ``scores`` product is rounded to the compute dtype before
  its fp32 use; ``y + x * D`` (prefill) rounds the product and the sum.

Softplus is the reference's ``logaddexp(x, 0)`` form,
``max(x, 0) + log1p(exp(-|x|))`` (``F.softplus`` switches to x above 20;
both agree within fp32 rounding).  ``A_log`` is ``log(linspace(1, 16,
H))`` from ``torch.linspace``: within one fp32 ulp (2.4e-7) of the
reference's (XLA reassociates ``jnp.linspace``'s arithmetic); the tests
carry the reference's exact values across with the converter.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------
def mamba_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Parameter name -> (shape, fan_in) in the reference's layout; the
    deterministic leaves (fan_in 0) are set by :func:`mamba_init`."""
    d, di = cfg.d_model, cfg.d_inner
    G, N, H, w = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_conv
    conv_ch = di + 2 * G * N
    return {"in_proj": ((d, 2 * di + 2 * G * N + H), d),
            "conv_w": ((w, conv_ch), w),
            "conv_b": ((conv_ch,), 0),
            "A_log": ((H,), 0),
            "D": ((H,), 0),
            "dt_bias": ((H,), 0),
            "norm": ((di,), 0),
            "out_proj": ((di, d), di)}


@torch.no_grad()
def mamba_init(p, cfg: ModelConfig, rng=None):
    """Fill ``p`` (a mapping holding ``mamba_shapes(cfg)``'s leaves) in
    place with the reference's scheme, drawn from the ``torch.Generator``
    ``rng``: the projections and the conv scaled normal (1/sqrt(fan_in)),
    ``conv_b`` and ``norm`` zeros, ``D`` ones, ``A_log = log(linspace(1,
    16, H))`` and ``dt_bias`` the inverse softplus of a log-uniform draw
    in [1e-3, 1e-1].  Returns ``p``."""
    H = cfg.ssm_nheads
    for name, (_, fan) in mamba_shapes(cfg).items():
        if fan:
            dense_init(p[name], fan, rng)
    if p["A_log"].device.type == "meta":
        return p
    p["conv_b"].zero_()
    p["norm"].zero_()
    p["D"].fill_(1.0)
    dev = p["A_log"].device
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, H,
                                              dtype=torch.float32,
                                              device=dev)))
    u = torch.empty((H,), dtype=torch.float32, device=dev).uniform_(
        math.log(1e-3), math.log(1e-1), generator=rng)
    p["dt_bias"].copy_(torch.log(torch.expm1(torch.exp(u))))
    return p


# ---------------------------------------------------------------------------
# elementwise helpers (the reference's op order; module doc)
# ---------------------------------------------------------------------------
def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA compiles it: x * (1 / (1 + exp(-x))), each
    op in ``x``'s dtype."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMSNorm of ``y * silu(z)`` in ``y``'s dtype: the product taken in
    fp32 and not rounded before the fp32 norm."""
    return rms_norm(y.float() * _silu(z).float(), scale, eps).to(y.dtype)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    z = proj[..., :di]
    xBC = proj[..., di: 2 * di + 2 * G * N]
    dt = proj[..., 2 * di + 2 * G * N:]
    return z, xBC, dt


def _split_xbc(cfg: ModelConfig, xBC: torch.Tensor):
    di, G, N = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state
    x = xBC[..., :di]
    Bm = xBC[..., di: di + G * N].reshape(*xBC.shape[:-1], G, N)
    Cm = xBC[..., di + G * N:].reshape(*xBC.shape[:-1], G, N)
    return x, Bm, Cm


def _causal_conv(xBC: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C), width W, silu activation:
    each product and each add in ``xBC``'s dtype, left to right."""
    W, S = w.shape[0], xBC.shape[1]
    dt = xBC.dtype
    pad = F.pad(xBC, (0, 0, W - 1, 0))
    out = pad[:, 0:S] * w[0].to(dt)
    for i in range(1, W):
        out = out + pad[:, i: i + S] * w[i].to(dt)
    return _silu(out + b.to(dt))


def _conv_step(conv_in: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Decode's conv over the window (B, W, C), before the silu: the W
    products summed in fp32 and rounded once, then the bias added, all in
    ``conv_in``'s dtype."""
    dt = conv_in.dtype
    out = (conv_in.float() * w.to(dt).float()).sum(dim=1).to(dt)
    return out + b.to(dt)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., i, j] = sum_{j < k <= i} x[..., k] as the difference of
    two cumsums, -inf above the diagonal (the reference's form)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~mask, -math.inf)


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, h0=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD forward.  x: (B, S, H, P), dt: (B, S, H) fp32, A: (H,),
    Bm/Cm: (B, S, G, N); S a multiple of ``chunk``.  Returns y (B, S, H, P)
    in x's dtype and the final state (B, H, P, N) fp32."""
    Bb, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    if S % chunk:
        raise ValueError(f"ssd_chunked: {S} steps are not a multiple of "
                         f"the chunk {chunk}")
    nc = S // chunk
    f32 = torch.float32

    dA = (dt.float() * A.float()).reshape(Bb, nc, chunk, H)
    dtx = (x * dt[..., None].to(x.dtype)).reshape(Bb, nc, chunk, H, P)
    Bc = Bm.reshape(Bb, nc, chunk, G, N)
    Cc = Cm.reshape(Bb, nc, chunk, G, N)
    dtx32 = dtx.to(f32)
    dA_cs = torch.cumsum(dA, dim=2)                              # (B,nc,l,H)

    # ---- intra-chunk (diagonal blocks) ---------------------------------
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))            # (B,nc,H,l,l)
    # (B,nc,G,l,N) @ (B,nc,G,N,l): rounded to x's dtype, then fp32
    scores = torch.matmul(Cc.permute(0, 1, 3, 2, 4),
                          Bc.permute(0, 1, 3, 4, 2)).to(f32)
    scores = scores.repeat_interleave(rep, dim=2)                # (B,nc,H,l,l)
    y_diag = torch.matmul(scores * Lmat, dtx32.permute(0, 1, 3, 2, 4))
    y_diag = y_diag.permute(0, 1, 3, 2, 4)                       # (B,nc,l,H,P)

    # ---- chunk states ----------------------------------------------------
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)       # (B,nc,l,H)
    xd = (decay_states[..., None] * dtx32).reshape(Bb, nc, chunk, G,
                                                   rep * P)
    # (B,nc,G,rep*P,l) @ (B,nc,G,l,N)
    states = torch.matmul(xd.permute(0, 1, 3, 4, 2),
                          Bc.to(f32).permute(0, 1, 3, 2, 4))
    states = states.reshape(Bb, nc, H, P, N)

    # ---- inter-chunk recurrence (each chunk gets its incoming state) ---
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                  # (B,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=x.device)
         if h0 is None else h0.to(f32))
    h_prev = states.new_empty((Bb, nc, H, P, N))
    for c in range(nc):
        h_prev[:, c] = h
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]

    # ---- prev-state contribution -----------------------------------------
    state_decay = torch.exp(dA_cs)                               # (B,nc,l,H)
    # (B,nc,G,rep*P,N) @ (B,nc,G,N,l)
    ch = torch.matmul(h_prev.reshape(Bb, nc, G, rep * P, N),
                      Cc.to(f32).permute(0, 1, 3, 4, 2))
    ch = ch.reshape(Bb, nc, H, P, chunk).permute(0, 1, 4, 2, 3)  # (B,nc,l,H,P)
    y_off = ch * state_decay[..., None]

    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
def mamba_apply(p, u: torch.Tensor, cfg: ModelConfig,
                return_cache: bool = False):
    """Full-sequence Mamba2 block.  u: (B, S, d_model).  With
    ``return_cache`` also the decode cache: ``h`` (B, H, P, N) fp32, the
    state after the S tokens, and ``conv`` (B, w-1, conv_ch), the last
    w-1 raw (pre-conv) inputs, left-padded with zeros when S < w-1."""
    Bb, S, _ = u.shape
    di, H, P = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim
    dtype = u.dtype
    proj = u @ p["in_proj"].to(dtype)
    z, xBC_raw, dt_raw = _split_proj(cfg, proj)
    xBC = _causal_conv(xBC_raw, p["conv_w"], p["conv_b"])
    x, Bm, Cm = _split_xbc(cfg, xBC)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    # pad S to whole chunks AFTER the softplus: the padded steps carry
    # dt = 0, so they neither decay nor feed the state
    chunk = min(cfg.ssm_chunk, S)
    padn = -(-S // chunk) * chunk - S
    xs, Bs, Cs, dts = x, Bm, Cm, dt
    if padn:
        xs = F.pad(x, (0, 0, 0, padn))
        Bs = F.pad(Bm, (0, 0, 0, 0, 0, padn))
        Cs = F.pad(Cm, (0, 0, 0, 0, 0, padn))
        dts = F.pad(dt, (0, 0, 0, padn))
    y, hT = ssd_chunked(xs.reshape(Bb, S + padn, H, P), dts, A, Bs, Cs,
                        chunk)
    y = y[:, :S] + x.reshape(Bb, S, H, P) * \
        p["D"].to(dtype)[None, None, :, None]
    y = _gated_norm(y.reshape(Bb, S, di), z, p["norm"], cfg.norm_eps)
    out = y @ p["out_proj"].to(dtype)
    if not return_cache:
        return out
    w = cfg.ssm_conv
    conv = F.pad(xBC_raw, (0, 0, max(w - 1 - S, 0), 0))[:, -(w - 1):]
    return out, {"h": hT, "conv": conv.to(dtype)}


def mamba_decode(p, u: torch.Tensor, cache, cfg: ModelConfig):
    """One-token recurrent step.  u: (B, 1, d_model); cache ``h`` (B, H,
    P, N) fp32 and ``conv`` (B, w-1, conv_ch), both written in place.
    Returns (out (B, 1, d_model), cache)."""
    Bb = u.shape[0]
    di, H, P, G = (cfg.d_inner, cfg.ssm_nheads, cfg.ssm_head_dim,
                   cfg.ssm_ngroups)
    dtype = u.dtype
    f32 = torch.float32
    proj = (u @ p["in_proj"].to(dtype))[:, 0]                   # (B, ·)
    z, xBC_new, dt_raw = _split_proj(cfg, proj)

    conv, h = cache["conv"], cache["h"]
    conv_in = torch.cat([conv, xBC_new[:, None, :].to(conv.dtype)],
                        dim=1)                                  # (B, w, C)
    xBC = _silu(_conv_step(conv_in.to(dtype), p["conv_w"], p["conv_b"]))
    x, Bm, Cm = _split_xbc(cfg, xBC)                            # (B,di),(B,G,N)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())       # (B, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)

    xh = x.reshape(Bb, H, P).to(f32)
    rep = H // G
    Bh = Bm.repeat_interleave(rep, dim=1).to(f32)               # (B, H, N)
    Ch = Cm.repeat_interleave(rep, dim=1).to(f32)
    h.mul_(dA[..., None, None]).add_(
        (dt[..., None, None] * xh[..., None]) * Bh[:, :, None, :])
    y = torch.matmul(h, Ch[..., None])[..., 0]                  # (B, H, P)
    y = y + xh * p["D"].float()[None, :, None]
    y = _gated_norm(y.reshape(Bb, di).to(dtype), z, p["norm"], cfg.norm_eps)
    out = (y @ p["out_proj"].to(dtype))[:, None, :]
    conv.copy_(conv_in[:, 1:])
    return out, cache


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------
def mamba_cache_spec(cfg: ModelConfig, batch: int, dtype):
    """The cache's tensors on the meta device (shapes and dtypes only)."""
    return mamba_cache_init(cfg, batch, dtype, device="meta")


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype, device=None):
    conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    return {
        "h": torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_head_dim,
                          cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
    }
