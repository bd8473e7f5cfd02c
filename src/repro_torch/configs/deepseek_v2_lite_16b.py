"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434.

27L d_model=2048 16H MLA (kv_lora_rank=512, qk_nope=128, qk_rope=64, v=128)
MoE: 64 routed experts top-6 + 2 shared, d_ff_expert=1408, vocab=102400.
The assignment line also says "160 routed"; we follow the actual
DeepSeek-V2-Lite card (64 routed) — see DESIGN.md §4.
"""
from .base import MLAConfig, ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,
        vocab_size=102400,
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128, q_lora_rank=0),
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408,
                      n_shared_experts=2),
        source="arXiv:2405.04434",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=64,
        vocab_size=512,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16, q_lora_rank=0),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64,
                      n_shared_experts=1),
        source="smoke",
    )
