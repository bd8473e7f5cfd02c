"""codeqwen1.5-7b [dense] — hf:Qwen/CodeQwen1.5-7B (qwen1.5 arch).

32L d_model=4096 32H (GQA kv=32 == MHA) d_ff=13440 vocab=92416, QKV bias.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        qkv_bias=True,
        rope_theta=1e6,
        source="hf:Qwen/CodeQwen1.5-7B",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        qkv_bias=True,
        source="smoke",
    )
