"""DeepSeek-V2 236B (MoE with Multi-head Latent Attention).

[arXiv:2405.04434] — 60L, d_model=5120, 128 heads with MLA
(kv_lora_rank=512, q_lora_rank=1536, qk_nope=128, qk_rope=64, v_head=128),
vocab=102400.  MoE: 160 routed experts top-6 + 2 shared experts, expert
d_ff=1536; the first layer uses a dense MLP (d_ff=12288).
"""
from repro_torch.configs.base import ATTN_GLOBAL, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        source="arXiv:2405.04434",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,           # per assignment table; MLA shares latent KV
        head_dim=128,
        d_ff=12_288,                # dense (first_k_dense) layers
        vocab_size=102_400,
        layer_pattern=(ATTN_GLOBAL,),
        use_mla=True,
        kv_lora_rank=512,
        q_lora_rank=1536,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        num_experts=160,
        num_shared_experts=2,
        moe_top_k=6,
        moe_d_ff=1536,
        first_k_dense=1,
        tie_embeddings=False,
        long_context_ok=False,
    )


def reduced() -> ModelConfig:
    return config().replace(
        name="deepseek-v2-236b-reduced",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        kv_lora_rank=64,
        q_lora_rank=96,
        qk_nope_head_dim=32,
        qk_rope_head_dim=16,
        v_head_dim=32,
        num_experts=4,
        num_shared_experts=1,
        moe_top_k=2,
        moe_d_ff=128,
        first_k_dense=1,
        moe_capacity_factor=8.0,   # dropless at smoke-test scale
        remat=False,
    )
