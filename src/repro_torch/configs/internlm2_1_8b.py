"""internlm2-1.8b [dense] — arXiv:2403.17297.

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=8,
        d_ff=8192,
        vocab_size=92544,
        rope_theta=1e6,
        source="arXiv:2403.17297",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="internlm2-1.8b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        source="smoke",
    )
