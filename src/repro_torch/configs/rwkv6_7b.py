"""rwkv6-7b [ssm] — arXiv:2404.05892 (RWKV-6 "Finch").

32L d_model=4096, attention-free (data-dependent decay WKV), d_ff=14336
channel-mix, vocab=65536. WKV heads: 64 x head_dim 64.
"""
from .base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        n_layers=32,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        d_ff=14336,
        vocab_size=65536,
        ssm=SSMConfig(kind="rwkv6", head_dim=64),
        attn_every=0,
        source="arXiv:2404.05892",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=128,
        n_heads=0,
        n_kv_heads=0,
        d_ff=256,
        vocab_size=512,
        ssm=SSMConfig(kind="rwkv6", head_dim=32),
        attn_every=0,
        source="smoke",
    )
