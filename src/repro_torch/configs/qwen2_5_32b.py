"""Qwen2.5-32B.

[hf:Qwen/Qwen2.5-0.5B card family] — 64L, d_model=5120, 40 heads
(GQA kv=8, head_dim=128), d_ff=27648, vocab=152064, QKV bias.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B",
        num_layers=64,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=27_648,
        vocab_size=152_064,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        layer_pattern=(ATTN_GLOBAL,),
        tie_embeddings=False,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="qwen2.5-32b-reduced",
        num_layers=2,
        d_model=320,
        num_heads=5,
        num_kv_heads=1,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        remat=False,
    )
