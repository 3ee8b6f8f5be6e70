"""Analytic per-step cost model (twin of ``repro/launch/costs.py``).

The reference's formulas, unchanged and float for float: a model of the
step, not a measurement of the port.  The reference keeps it because
XLA's ``compiled.cost_analysis()`` counts a ``while`` body once whatever
its trip count, and every model there scans over its layers.  The port's
dry run (``launch/dryrun.py``) counts the FLOPs of the step it runs
(``FlopCounterMode``; Python loops unroll, so nothing is undercounted)
and records this model beside the count as ``analytic``.  The model,
as the reference states it (exact for matmul-dominated transformers):

- FLOPs: 6*N_active*D for train (2 fwd + 4 bwd) plus the remat
  re-forward (+2), 2*N_active*D for single forwards, plus attention
  score/value matmul terms 4*B*S*S_eff*H*hd per attention layer
  (doubled/tripled for bwd the same way).
- HBM traffic: parameter+optimizer state streams per step kind (decode
  is the classic weights-bound case: every parameter is read once per
  token), plus KV-cache and saved-activation streams.

Where the port differs from the model's assumptions:

- Decode's ``p_bytes / 2`` assumes bf16-served weights.  The port holds
  fp32 weights and casts each to the compute dtype at each use (ROADMAP,
  loose ends), so its decode reads every weight's 4 bytes and writes
  and reads a bf16 copy: above the model's traffic.
- N counts the embedding, a gather that does no multiply, and the head,
  which the port's prefill runs on the last position only; so a counted
  prefill comes under the model.  Whisper's model leaves out its encoder
  over ``encoder_seq`` frames.
- Collectives: the reference parses them from the HLO; one card has
  none, and the port has no HLO.
- The quantities are global; on one card global is per device.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import InputShape, ModelConfig


@dataclass
class StepCosts:
    flops: float                 # global FLOPs per step
    hbm_bytes: float             # global HBM traffic per step
    param_bytes_state: float     # params + opt state resident bytes
    cache_bytes: float           # KV/SSM cache resident bytes


def _attn_flops_per_layer(cfg: ModelConfig, B: int, Sq: int, Sk: int,
                          window: int) -> float:
    """Score + value matmuls (2 GEMMs), 2*...*2 flops."""
    s_eff = min(Sk, window) if window > 0 else Sk
    if cfg.use_mla:
        hd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        vd = cfg.v_head_dim
        return 2.0 * B * Sq * s_eff * cfg.num_heads * (hd + vd)
    return 4.0 * B * Sq * s_eff * cfg.num_heads * cfg.head_dim


def _attn_layers(cfg: ModelConfig, long_mode: bool):
    """(count, window) pairs for attention layers incl. zamba shared."""
    out = []
    for k in cfg.layer_kinds():
        if k == "local":
            out.append(cfg.sliding_window)
        elif k == "global":
            out.append(cfg.long_context_window if long_mode else 0)
        elif k == "mamba+shared_attn":
            out.append(cfg.long_context_window if long_mode else 0)
    if cfg.is_encoder_decoder:
        out += [0] * cfg.num_encoder_layers          # bidirectional enc
        out += [0] * cfg.num_layers                  # cross attention
    return out


def _cache_bytes(cfg: ModelConfig, B: int, S: int, long_mode: bool,
                 dtype_bytes: int = 2) -> float:
    total = 0.0
    kinds = cfg.layer_kinds()
    n_attn = sum(1 for k in kinds if not k.startswith("mamba"))
    n_shared = sum(1 for k in kinds if k == "mamba+shared_attn")
    n_mamba = sum(1 for k in kinds if k.startswith("mamba"))
    if long_mode:
        cache_len = min(S, max(cfg.sliding_window or S,
                               cfg.long_context_window or S))
    else:
        cache_len = S
    if cfg.use_mla:
        per_pos = cfg.kv_lora_rank + cfg.qk_rope_head_dim
        total += cfg.num_layers * B * cache_len * per_pos * dtype_bytes
    else:
        per_pos = 2 * cfg.num_kv_heads * cfg.head_dim
        total += (n_attn + n_shared) * B * cache_len * per_pos * dtype_bytes
    if n_mamba:
        conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        total += n_mamba * B * (
            cfg.ssm_nheads * cfg.ssm_head_dim * cfg.ssm_state * 4   # h fp32
            + (cfg.ssm_conv - 1) * conv_ch * dtype_bytes)
    if cfg.is_encoder_decoder:
        total += cfg.num_layers * B * cfg.encoder_seq * \
            2 * cfg.num_kv_heads * cfg.head_dim * dtype_bytes
    return total


def step_costs(cfg: ModelConfig, shape: InputShape,
               long_mode: bool = False) -> StepCosts:
    B, S = shape.global_batch, shape.seq_len
    N = cfg.active_param_count()
    p_bytes = cfg.param_count() * 4                      # fp32 master
    opt_bytes = cfg.param_count() * 8                    # adam mu+nu fp32

    if shape.step_kind == "train":
        D = B * S
        trunk = 6.0 * N * D                              # fwd(2) + bwd(4)
        if cfg.remat:
            trunk += 2.0 * N * D                         # re-forward
        attn = sum(_attn_flops_per_layer(cfg, B, S, S, w)
                   for w in _attn_layers(cfg, long_mode))
        attn_total = attn * (4.0 if cfg.remat else 3.0)
        flops = trunk + attn_total
        # params fwd+remat+bwd reads (bf16 cast reads of fp32 master ~3x)
        # + grad write + adam read/write
        hbm = 3 * p_bytes + p_bytes + 2 * opt_bytes + p_bytes
        # saved residuals r/w (bf16) and logits r/w (fp32)
        hbm += 2 * (cfg.num_layers * B * S * cfg.d_model * 2)
        hbm += 2 * (B * S * cfg.vocab_size * 4)
        return StepCosts(flops, hbm, p_bytes + opt_bytes, 0.0)

    if shape.step_kind == "prefill":
        D = B * S
        attn = sum(_attn_flops_per_layer(cfg, B, S, S, w)
                   for w in _attn_layers(cfg, long_mode))
        flops = 2.0 * N * D + attn
        cache = _cache_bytes(cfg, B, S, long_mode)
        hbm = p_bytes + cache + 2 * (cfg.num_layers * B * S *
                                     cfg.d_model * 2)
        return StepCosts(flops, hbm, p_bytes, cache)

    # decode: one token against an S-long cache
    D = B * 1
    attn = sum(_attn_flops_per_layer(cfg, B, 1, S, w)
               for w in _attn_layers(cfg, long_mode))
    flops = 2.0 * N * D + attn
    cache = _cache_bytes(cfg, B, S, long_mode)
    # the decode roofline: read EVERY weight + the whole cache per step
    hbm = p_bytes / 2 + cache            # weights usually bf16-served: /2
    return StepCosts(flops, hbm, p_bytes / 2, cache)
