"""Whisper-small (encoder-decoder ASR).

[arXiv:2212.04356] — 12L encoder + 12L decoder, d_model=768, 12 heads
(MHA), d_ff=3072, vocab=51865.  The mel-spectrogram + 2x conv frontend is a
STUB per the assignment: ``input_specs`` supplies pre-computed frame
embeddings (1500 frames) of shape (batch, 1500, d_model).  Decoder uses
learned positions in the real model; we use RoPE-free sinusoidal-as-learned
stub (absolute embedding table) — backbone shape-faithful.
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        family="audio",
        source="arXiv:2212.04356",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=51_872,   # 51865 padded to a multiple of 16 (Megatron-style
        # vocab padding so the head/logits shard over the model axis)
        act="gelu",
        gated_mlp=False,
        layer_pattern=(ATTN_GLOBAL,),
        is_encoder_decoder=True,
        num_encoder_layers=12,
        encoder_seq=1500,
        frontend="audio",
        tie_embeddings=True,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="whisper-small-reduced",
        num_layers=2,
        num_encoder_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        encoder_seq=32,
        remat=False,
    )
