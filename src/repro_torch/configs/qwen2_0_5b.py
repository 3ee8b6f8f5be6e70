"""Qwen2-0.5B.

[arXiv:2407.10671] — 24L, d_model=896, 14 heads (GQA kv=2, head_dim=64),
d_ff=4864, vocab=151936, QKV bias.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b",
        family="dense",
        source="arXiv:2407.10671",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab_size=151_936,
        qkv_bias=True,
        rope_theta=1_000_000.0,
        layer_pattern=(ATTN_GLOBAL,),
        tie_embeddings=True,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="qwen2-0.5b-reduced",
        num_layers=2,
        d_model=224,
        num_heads=7,
        num_kv_heads=1,
        head_dim=32,
        d_ff=448,
        vocab_size=512,
        remat=False,
    )
