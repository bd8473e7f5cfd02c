"""llama-7b-paper — the paper's own evaluation model (Llama 7B, §V-C).

32L d_model=4096 32H MHA d_ff=11008 vocab=32000. Used by the serving
engine examples, cost-model calibration, and kernel benches.
"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-7b-paper",
        family="dense",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=32,
        d_ff=11008,
        vocab_size=32000,
        source="paper §V-C / arXiv:2302.13971",
    )


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama-7b-paper-smoke",
        family="dense",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        source="smoke",
    )
