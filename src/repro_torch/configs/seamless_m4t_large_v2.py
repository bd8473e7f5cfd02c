"""seamless-m4t-large-v2 [audio, enc-dec] — arXiv:2308.11596.

24L (per stack) d_model=1024 16H (GQA kv=16 == MHA) d_ff=8192 vocab=256206.
Speech frontend (mel + conformer conv) is a STUB: the encoder consumes
precomputed frame embeddings (batch, n_frames, 1024).
"""
from .base import EncoderConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        cross_attn_every=1,          # every decoder layer cross-attends
        encoder=EncoderConfig(n_layers=24, n_frames=1024),
        source="arXiv:2308.11596",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2-smoke",
        family="audio",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        cross_attn_every=1,
        encoder=EncoderConfig(n_layers=2, n_frames=16),
        source="smoke",
    )
