"""Phi-3.5-MoE (42B total / 6.6B active).

[hf:microsoft/Phi-3.5-MoE-instruct] — 32L, d_model=4096, 32 heads
(GQA kv=8, head_dim=128), vocab=32064.  MoE: 16 experts top-2, expert
d_ff=6400, no shared experts.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b",
        family="moe",
        source="hf:microsoft/Phi-3.5-MoE-instruct",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=6400,
        vocab_size=32_064,
        layer_pattern=(ATTN_GLOBAL,),
        num_experts=16,
        num_shared_experts=0,
        moe_top_k=2,
        moe_d_ff=6400,
        tie_embeddings=False,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="phi3.5-moe-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab_size=512,
        num_experts=4,
        moe_top_k=2,
        moe_d_ff=256,
        moe_capacity_factor=8.0,   # dropless at smoke-test scale
        remat=False,
    )
