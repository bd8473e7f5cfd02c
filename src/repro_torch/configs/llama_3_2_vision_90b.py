"""llama-3.2-vision-90b [vlm] — hf:meta-llama/Llama-3.2-11B-Vision (family).

100L (80 self-attn + 20 cross-attn, every 5th layer) d_model=8192 64H
(GQA kv=8) d_ff=28672 vocab=128256. Vision encoder is a STUB: cross-attn
consumes precomputed patch embeddings (batch, n_patches, d_model).
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        n_layers=100,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
        vocab_size=128256,
        cross_attn_every=5,
        n_frontend_tokens=1601,      # 1 tile of 1600 patches + cls
        rope_theta=5e5,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b-smoke",
        family="vlm",
        n_layers=5,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        cross_attn_every=5,
        n_frontend_tokens=16,
        source="smoke",
    )
