"""llama4-scout-17b-a16e [moe] — hf:meta-llama/Llama-4-Scout-17B-16E.

48L d_model=5120 40H (GQA kv=8) d_ff_expert=8192 vocab=202048,
MoE 16 experts top-1 (+1 shared expert, early-fusion text backbone).
"""
from .base import ModelConfig, MoEConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        n_layers=48,
        d_model=5120,
        n_heads=40,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      n_shared_experts=1),
        rope_theta=5e5,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e-smoke",
        family="moe",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=256,
                      n_shared_experts=1),
        source="smoke",
    )
