"""Mamba2-130M (SSD — state-space duality).

[arXiv:2405.21060] — 24L, d_model=768, attention-free, vocab=50280,
d_state=128, expand=2 (d_inner=1536), head_dim=64 (24 SSM heads), conv=4.
Runs long_500k natively: decode state is O(1) in sequence length.
"""
from repro_torch.configs.base import MAMBA, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-130m",
        family="ssm",
        source="arXiv:2405.21060",
        num_layers=24,
        d_model=768,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_288,   # 50280 padded to a multiple of 16 (vocab padding
        # for tensor-parallel head sharding)
        layer_pattern=(MAMBA,),
        ssm_state=128,
        ssm_conv=4,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_ngroups=1,
        ssm_chunk=256,
        tie_embeddings=True,
        long_context_ok=True,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="mamba2-130m-reduced",
        num_layers=2,
        d_model=256,
        vocab_size=512,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_chunk=32,
        remat=False,
    )
