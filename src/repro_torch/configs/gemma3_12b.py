"""Gemma-3 12B.

[hf:google/gemma-3-1b-pt family] — 48L, d_model=3840, 16 heads (GQA kv=8,
head_dim=256), d_ff=15360, vocab=262144.  5:1 local:global attention with
sliding window 1024 on local layers; 128k context.  long_500k runs via the
long-context variant (global layers windowed, DESIGN.md §4).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ATTN_LOCAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        source="hf:google/gemma-3-1b-pt",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15_360,
        vocab_size=262_144,
        act="gelu",
        rope_theta=1_000_000.0,
        sliding_window=1024,
        layer_pattern=(ATTN_LOCAL,) * 5 + (ATTN_GLOBAL,),
        tie_embeddings=True,
        long_context_ok=True,
        long_context_window=1024,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="gemma3-12b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        sliding_window=64,
        long_context_window=64,
        layer_pattern=("local", "global"),
        remat=False,
    )
