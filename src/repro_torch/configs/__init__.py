"""Config registry of the PyTorch port: `get_config(arch_id)` and
`get_smoke_config(arch_id)`.

The dataclasses in ``base.py`` and the model file are copies of the JAX
package's; ``tests/test_torch_port_rules.py`` holds them field for field
against the originals. Only the paper's own model is registered: the
other families wait for ROADMAP queue A item 11.
"""
from __future__ import annotations

from . import llama_7b_paper
from .base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW, EncoderConfig,
                   InputShape, LoRAConfig, MLAConfig, ModelConfig, MoEConfig,
                   SSMConfig)

_REGISTRY = {llama_7b_paper.config().name: llama_7b_paper}

ARCH_IDS = sorted(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    return _REGISTRY[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _REGISTRY[arch_id].reduced()


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "EncoderConfig",
    "LoRAConfig", "InputShape", "INPUT_SHAPES", "LONG_CONTEXT_WINDOW",
    "ARCH_IDS", "get_config", "get_smoke_config",
]
