"""Configuration system (twin of ``repro/configs/base.py``, copied as
it is: plain dataclasses).

``ModelConfig`` is a single frozen dataclass wide enough to describe every
assigned architecture family (dense / MoE / SSM / hybrid / VLM / audio
enc-dec).  Architecture files under ``repro_torch.configs`` instantiate it with the
exact published numbers and also provide a ``reduced()`` variant used by the
CPU smoke tests (<=2 layers, d_model <= 512, <=4 experts).

``InputShape`` describes the four assigned workload shapes.  ``step_kind``
decides which step function the launcher lowers (train / prefill / decode).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer kinds used in ``layer_pattern``
# ---------------------------------------------------------------------------
ATTN_GLOBAL = "global"      # full causal attention
ATTN_LOCAL = "local"        # sliding-window causal attention
MAMBA = "mamba"             # Mamba2 (SSD) block
MAMBA_SHARED_ATTN = "mamba+shared_attn"  # zamba2: mamba block followed by the
                                          # shared (weight-tied) attention block


@dataclass(frozen=True)
class ModelConfig:
    # -- identity ----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (arXiv id / model card)

    # -- trunk -------------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 0                    # dense-MLP hidden size (0 for pure SSM)
    vocab_size: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    act: str = "silu"                # silu | gelu
    gated_mlp: bool = True           # SwiGLU-style (w_gate, w_up, w_down)

    # -- attention ---------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0        # 0 disables (gemma2: 50.0)
    final_softcap: float = 0.0       # logit softcap at the LM head (gemma2: 30)
    sliding_window: int = 0          # window for ATTN_LOCAL layers
    layer_pattern: Tuple[str, ...] = (ATTN_GLOBAL,)
    # pattern is tiled to cover num_layers; len(pattern) is the scan group.

    # -- MLA (deepseek-v2) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # -- MoE -----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden size
    first_k_dense: int = 0           # deepseek: leading dense layers
    router_aux_coef: float = 0.001
    moe_capacity_factor: float = 1.25   # GShard-style; tokens beyond an
    # expert's capacity are dropped, so results are batch-composition
    # dependent (reduced test configs use a dropless factor)

    # -- SSM (mamba2 / zamba2) -----------------------------------------------
    ssm_state: int = 0               # N (d_state)
    ssm_conv: int = 4                # depthwise conv width
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_head_dim: int = 64           # P (head dim); nheads = d_inner / P
    ssm_ngroups: int = 1
    ssm_chunk: int = 256             # SSD chunk length

    # -- hybrid (zamba2) -------------------------------------------------------
    shared_attn_period: int = 0      # apply shared attn block every k layers

    # -- encoder-decoder (whisper) --------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # e.g. 1500 mel frames after conv stub

    # -- modality frontend stub (vlm / audio) ---------------------------------
    frontend: str = ""               # "" | "vision" | "audio"
    num_prefix_tokens: int = 0       # vision patch embeddings prepended

    # -- long-context -----------------------------------------------------------
    long_context_ok: bool = False    # may lower long_500k decode
    long_context_window: int = 0     # window applied to *global* layers in
                                     # long-context decode mode (0 = native)

    # -- training ----------------------------------------------------------------
    remat: bool = True               # jax.checkpoint over the layer scan
    chunked_ce: bool = False         # seq-chunked CE loss (never materialize
    #                                  the full fp32 logits) — §Perf lever
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm_only(self) -> bool:
        return all(k.startswith("mamba") for k in self.layer_pattern) and \
            self.shared_attn_period == 0 and "shared_attn" not in "".join(self.layer_pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """The per-layer kind list, pattern tiled to num_layers."""
        pat = self.layer_pattern
        reps = -(-self.num_layers // len(pat))
        return tuple((pat * reps)[: self.num_layers])

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- rough parameter counts (used by roofline's 6ND) -----------------------
    def param_count(self, active_only: bool = False) -> int:
        """Analytic parameter count of the trunk + embeddings.

        ``active_only`` counts only top-k routed experts (MoE 6·N_active·D).
        """
        d, L = self.d_model, self.num_layers
        total = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        kinds = self.layer_kinds()
        for i, kind in enumerate(kinds):
            total += 2 * d  # norms
            if kind.startswith("mamba"):
                # a mamba layer IS the mixer; no separate MLP (zamba2's d_ff
                # belongs to the shared attention block, counted once below)
                total += self._mamba_params()
            else:
                total += self._attn_params()
                total += self._mlp_params(i)
        if self.shared_attn_period or MAMBA_SHARED_ATTN in kinds:
            total += self._attn_params() + self._dense_mlp_params()
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += self._attn_params() + self._dense_mlp_params() + 2 * d
            # decoder cross-attention
            total += self.num_layers * self._attn_params()
        if active_only and self.is_moe:
            pass  # handled in _mlp_params via active flag; recompute:
        return total

    def active_param_count(self) -> int:
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        per_expert = self._expert_params()
        n_moe_layers = max(self.num_layers - self.first_k_dense, 0)
        inactive = (self.num_experts - self.moe_top_k) * per_expert * n_moe_layers
        return full - inactive

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        if self.use_mla:
            r_kv, r_q = self.kv_lora_rank, self.q_lora_rank
            nope, rope, vh = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
            H = self.num_heads
            p = d * (r_q + r_kv + rope)                      # down-projections
            p += r_q * H * (nope + rope)                     # q up
            p += r_kv * H * (nope + vh)                      # kv up
            p += H * vh * d                                  # output
            return p
        q = d * self.num_heads * hd
        kv = 2 * d * self.num_kv_heads * hd
        o = self.num_heads * hd * d
        bias = (self.num_heads + 2 * self.num_kv_heads) * hd if self.qkv_bias else 0
        return q + kv + o + bias

    def _dense_mlp_params(self) -> int:
        mult = 3 if self.gated_mlp else 2
        return mult * self.d_model * self.d_ff

    def _expert_params(self) -> int:
        mult = 3 if self.gated_mlp else 2
        return mult * self.d_model * self.moe_d_ff

    def _mlp_params(self, layer_idx: int) -> int:
        if self.is_moe and layer_idx >= self.first_k_dense:
            p = self.num_experts * self._expert_params()
            p += self.num_shared_experts * self._expert_params()
            p += self.d_model * self.num_experts  # router
            return p
        if self.d_ff == 0:
            return 0
        return self._dense_mlp_params()

    def _mamba_params(self) -> int:
        d, di, N = self.d_model, self.d_inner, self.ssm_state
        H = self.ssm_nheads
        G = self.ssm_ngroups
        in_proj = d * (2 * di + 2 * G * N + H)   # z, x, B, C, dt
        conv = self.ssm_conv * (di + 2 * G * N)
        out = di * d
        extra = di + 2 * H                        # D skip, A_log, dt_bias
        return in_proj + conv + out + extra


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    step_kind: str           # train | prefill | decode


SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: InputShape) -> Tuple[bool, str]:
    """Whether (arch, shape) must be lowered; reason if skipped.

    long_500k requires sub-quadratic attention: SSM/hybrid run natively,
    dense archs run only when a sliding-window variant exists
    (``long_context_ok``).  Pure full-attention archs skip (per DESIGN.md).
    """
    if shape.name == "long_500k" and not cfg.long_context_ok:
        return False, "full-attention arch: long_500k skipped (DESIGN.md §4)"
    return True, ""


# ---------------------------------------------------------------------------
# DTSVM (paper) experiment configuration
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class DTSVMConfig:
    """Hyper-parameters of the paper's algorithm (Section IV defaults)."""
    num_nodes: int = 10          # V
    num_tasks: int = 3           # T
    dim: int = 10                # p  (paper: PCA -> 10)
    C: float = 0.01
    eps1: float = 1.0
    eps2: float = 1.0
    eta1: float = 1.0
    eta2: float = 1.0
    admm_iters: int = 100
    qp_iters: int = 200          # projected-gradient iterations for (6)
    graph: str = "random"        # ring | full | random
    graph_degree: float = 0.8    # target degree (paper's definition)
    seed: int = 0
