"""Config registry of the PyTorch port: `get_config(arch_id)` and
`get_smoke_config(arch_id)`.

The dataclasses in ``base.py`` and the model files are copies of the JAX
package's; ``tests/test_torch_port_rules.py`` holds them field for field
against the originals. Registered: the families the port serves — the
dense models and the MoE family (with or without MLA). The hybrid, SSM,
VLM and audio configs wait for ROADMAP queue A item 10, and
``get_config`` on them raises ``KeyError``.
"""
from __future__ import annotations

from . import (codeqwen1_5_7b, deepseek_v2_lite_16b, internlm2_1_8b,
               llama4_scout_17b_16e, llama_7b_paper, qwen2_5_32b,
               stablelm_1_6b)
from .base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW, EncoderConfig,
                   InputShape, LoRAConfig, MLAConfig, ModelConfig, MoEConfig,
                   SSMConfig)

_REGISTRY = {mod.config().name: mod for mod in (
    llama_7b_paper, qwen2_5_32b, codeqwen1_5_7b, internlm2_1_8b,
    stablelm_1_6b, deepseek_v2_lite_16b, llama4_scout_17b_16e)}

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
