"""Mixture-of-Experts layer: top-k router + grouped capacity dispatch (twin
of ``repro/models/moe.py``).

GShard/Switch-style with *grouped* dispatch: tokens are split into G
groups, each group scatters its tokens into per-expert buffers of static
capacity using group-local cumsums.  The reference ``vmap``s one group's
dispatch and combine over G; here each is one batched op over the leading
G axis.  Tokens beyond an expert's per-group capacity are dropped (GShard
semantics: results depend on batch composition; the reduced configs use a
dropless factor, ``moe_capacity_factor = E / K`` or more).

Kept exactly as the reference has them, since each decides which
assignments survive: ``_NUM_GROUPS`` and its halving loop, the capacity
by Python's ``round`` (half to even), the router product of the
compute-dtype operands kept in fp32 (``route``) then the softmax in
fp32, top-k with ties broken by the lower index
(a stable descending sort: ``torch.topk`` does not promise that order),
and the exclusive cumsum over the token-major, k-minor flattening.

The reference's ``shard_hint`` calls have no twin: one card has no mesh.
The expert products are plain ``torch.einsum``, as the reference leaves
them to XLA.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init

_NUM_GROUPS = 32   # the reference's (pod x data) extent of its mesh


def moe_shapes(cfg: ModelConfig) -> Dict[str, tuple]:
    """Parameter name -> (shape, fan_in) in the reference's layout;
    ``shared`` maps to a nested dict of the same where the config has
    shared experts."""
    d, E, dff = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    shapes = {"router": ((d, E), d), "gate": ((E, d, dff), d),
              "up": ((E, d, dff), d), "down": ((E, dff, d), dff)}
    if cfg.num_shared_experts:
        dsh = dff * cfg.num_shared_experts
        shapes["shared"] = {"gate": ((d, dsh), d), "up": ((d, dsh), d),
                            "down": ((dsh, d), dsh)}
    return shapes


def moe_init(p, cfg: ModelConfig, rng=None):
    """Fill ``p`` (a mapping holding ``moe_shapes(cfg)``'s leaves) in place
    with the reference's scheme (scaled normal, 1/sqrt(fan_in)), drawn
    from the ``torch.Generator`` ``rng``; returns ``p``."""
    def fill(node, shapes):
        for name, spec in shapes.items():
            if isinstance(spec, dict):
                fill(node[name], spec)
            else:
                dense_init(node[name], spec[1], rng)
    fill(p, moe_shapes(cfg))
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------
def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """xt: (T, d) -> (probs (T, E) fp32, gate_w (T, K) renormalised,
    gate_i (T, K) int64).  Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them.  The logits are the product of the
    compute-dtype operands summed in fp32 and never rounded: XLA folds
    the reference's ``.astype(float32)`` into the dot, so in bf16 its
    logits are not the rounded bf16 product's."""
    logits = xt.float() @ p["router"].to(xt.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    gate_w, gate_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    K = cfg.moe_top_k
    gate_w, gate_i = gate_w[:, :K], gate_i[:, :K]
    return probs, gate_w / gate_w.sum(dim=-1, keepdim=True), gate_i


def groups(T: int) -> int:
    """The reference's group count for T tokens (its halving loop)."""
    G = _NUM_GROUPS
    while T % G != 0 or T // G < 1:
        G //= 2
        if G <= 1:
            G = 1
            break
    return G


def capacity(Tg: int, cfg: ModelConfig, capacity_factor: float) -> int:
    """Slots per expert and group: Python's ``round`` (half to even), at
    least min(Tg, 8), at most Tg."""
    E, K = cfg.num_experts, cfg.moe_top_k
    cap = int(max(1, round(Tg * K / E * capacity_factor)))
    return min(Tg, max(cap, min(Tg, 8)))


# ---------------------------------------------------------------------------
# dispatch / combine, batched over the leading group axis
# ---------------------------------------------------------------------------
def _dispatch_group(xg, ig, E: int, cap: int):
    """xg: (G, Tg, d); ig: (G, Tg, K).  Returns the per-expert buffers
    (G, E, cap, d), and per assignment (token-major, k-minor) its expert,
    its slot (clamped to cap - 1, as the reference's) and whether it was
    kept."""
    G, Tg, d = xg.shape
    K = ig.shape[-1]
    flat_e = ig.reshape(G, Tg * K)
    onehot = F.one_hot(flat_e, E)                        # (G, Tg*K, E)
    pos_in_e = onehot.cumsum(dim=1) - onehot             # exclusive
    pos = pos_in_e.gather(2, flat_e[..., None])[..., 0]
    keep = pos < cap
    # kept (e, pos) pairs are unique; dropped rows land in a spare slot
    # ``cap`` that is sliced away, so the scatter needs no accumulation
    # and no host sync
    slot = torch.where(keep, pos, cap)
    gidx = torch.arange(G, device=xg.device)[:, None]
    buf = xg.new_zeros((G, E, cap + 1, d))
    buf.index_put_((gidx, flat_e, slot), xg.repeat_interleave(K, dim=1))
    return buf[:, :, :cap], flat_e, torch.clamp(pos, max=cap - 1), keep


def _combine_group(out_buf, flat_e, pos, keep, wg):
    """out_buf: (G, E, cap, d); wg: (G, Tg, K) -> (G, Tg, d), the sum over
    K in the compute dtype."""
    G, Tg, K = wg.shape
    gidx = torch.arange(G, device=out_buf.device)[:, None]
    gathered = out_buf[gidx, flat_e, pos]                # (G, Tg*K, d)
    gathered = torch.where(keep[..., None], gathered, 0)
    w = wg.reshape(G, Tg * K, 1).to(gathered.dtype)
    return (gathered * w).reshape(G, Tg, K, -1).sum(dim=2)


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig,
              capacity_factor: float = 0.0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss).  Grouped static-capacity dispatch."""
    if capacity_factor <= 0.0:
        capacity_factor = cfg.moe_capacity_factor
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.moe_top_k
    T = B * S
    xt = x.reshape(T, d)

    probs, gate_w, gate_i = route(p, xt, cfg)

    # --- aux load-balance loss (Switch) ---------------------------------
    me = probs.mean(dim=0)
    ce = F.one_hot(gate_i[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    # --- grouped dispatch -------------------------------------------------
    G = groups(T)
    Tg = T // G
    cap = capacity(Tg, cfg, capacity_factor)
    wg = gate_w.reshape(G, Tg, K)
    buf, flat_e, pos, keep = _dispatch_group(
        xt.reshape(G, Tg, d), gate_i.reshape(G, Tg, K), E, cap)

    f = act_fn(cfg.act)
    h = f(torch.einsum("gecd,edf->gecf", buf, p["gate"].to(x.dtype)))
    h = h * torch.einsum("gecd,edf->gecf", buf, p["up"].to(x.dtype))
    out_buf = torch.einsum("gecf,efd->gecd", h, p["down"].to(x.dtype))

    y = _combine_group(out_buf, flat_e, pos, keep, wg).reshape(T, d)

    if "shared" in p:
        sp = p["shared"]
        hs = f(xt @ sp["gate"].to(x.dtype)) * (xt @ sp["up"].to(x.dtype))
        y = y + hs @ sp["down"].to(x.dtype)

    return y.reshape(B, S, d), aux
