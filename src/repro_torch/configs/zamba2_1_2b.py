"""Zamba2-1.2B (hybrid Mamba2 + shared attention).

[arXiv:2411.15242] — 38 Mamba2 layers, d_model=2048, d_state=64; one
weight-tied ("shared") full-attention transformer block (32 heads, MHA
kv=32, d_ff=8192) is applied every 6th layer, vocab=32000.  The shared
block's weights are reused at every invocation — exactly the paper's
"shared term" made architectural.  long_500k runs: the Mamba2 backbone is
O(1)-state and the shared attention falls back to a window in long mode.
"""
from repro_torch.configs.base import MAMBA, MAMBA_SHARED_ATTN, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        source="arXiv:2411.15242",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=32_000,
        layer_pattern=(MAMBA,) * 5 + (MAMBA_SHARED_ATTN,),
        shared_attn_period=6,
        ssm_state=64,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        tie_embeddings=True,
        long_context_ok=True,
        long_context_window=4096,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="zamba2-1.2b-reduced",
        num_layers=4,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        layer_pattern=(MAMBA, MAMBA_SHARED_ATTN),
        shared_attn_period=2,
        ssm_state=16,
        ssm_head_dim=32,
        ssm_chunk=32,
        long_context_window=64,
        remat=False,
    )
