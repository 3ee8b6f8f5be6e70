"""InternVL2-2B language backbone (InternLM2-1.8B) + stub ViT frontend.

[arXiv:2404.16821] — 24L, d_model=2048, 16 heads (GQA kv=8), d_ff=8192,
vocab=92553.  The InternViT-300M vision encoder and the MLP projector are a
STUB per the assignment: ``input_specs`` supplies pre-computed patch
embeddings (256 patches per image after pixel-shuffle) of shape
(batch, 256, d_model).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-2b",
        family="vlm",
        source="arXiv:2404.16821",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92_560,   # 92553 padded to a multiple of 16 (vocab padding
        # for tensor-parallel head sharding)
        rope_theta=1_000_000.0,
        layer_pattern=(ATTN_GLOBAL,),
        frontend="vision",
        num_prefix_tokens=256,
        tie_embeddings=False,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="internvl2-2b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        num_prefix_tokens=8,
        remat=False,
    )
