"""zamba2-7b [hybrid] — arXiv:2411.15242.

81 Mamba2 blocks, d_model=3584, ssm_state=64; a SHARED full-attention block
(32H, GQA kv=32, d_ff=14336 MLP) applied every 6 blocks. vocab=32000.
"""
from .base import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab_size=32000,
        ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2),
        attn_every=6,
        shared_attn=True,
        source="arXiv:2411.15242",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=4,          # 4 mamba blocks, shared attn every 2
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        ssm=SSMConfig(kind="mamba2", d_state=16, head_dim=32, expand=2),
        attn_every=2,
        shared_attn=True,
        source="smoke",
    )
