"""Gemma-2 2B.

[arXiv:2408.00118] — 26L, d_model=2304, 8 heads (GQA kv=4, head_dim=256),
d_ff=9216, vocab=256000.  Local (sliding-window 4096) and global attention
alternate 1:1; attention logits soft-capped at 50, final logits at 30.
GeGLU MLP.  long_500k runs via the long-context variant: global layers fall
back to a 4096 window (DESIGN.md §4).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        source="arXiv:2408.00118",
        num_layers=26,
        d_model=2304,
        num_heads=8,
        num_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab_size=256_000,
        act="gelu",
        attn_softcap=50.0,
        final_softcap=30.0,
        sliding_window=4096,
        layer_pattern=(ATTN_LOCAL, ATTN_GLOBAL),
        tie_embeddings=True,
        long_context_ok=True,
        long_context_window=4096,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="gemma2-2b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        long_context_window=64,
        remat=False,
    )
