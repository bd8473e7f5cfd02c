"""Config registry of the PyTorch port: `get_config(arch_id)` and
`get_smoke_config(arch_id)`.

The dataclasses in ``base.py`` and the model files are copies of the JAX
package's; ``tests/test_torch_port_rules.py`` holds them field for field
against the originals. Every config of the JAX package is registered, and
the port serves each: the dense models, the MoE family (with or without
MLA), the hybrid (zamba2: Mamba2 with a shared attention block), the SSM
(RWKV-6), the VLM (llama-3.2-vision: a gated cross-attention block after
every four self-attention layers) and the audio encoder-decoder
(seamless-m4t).
"""
from __future__ import annotations

from . import (codeqwen1_5_7b, deepseek_v2_lite_16b, internlm2_1_8b,
               llama4_scout_17b_16e, llama_3_2_vision_90b, llama_7b_paper,
               qwen2_5_32b, rwkv6_7b, seamless_m4t_large_v2, stablelm_1_6b,
               zamba2_7b)
from .base import (INPUT_SHAPES, LONG_CONTEXT_WINDOW, EncoderConfig,
                   InputShape, LoRAConfig, MLAConfig, ModelConfig, MoEConfig,
                   SSMConfig)

_REGISTRY = {mod.config().name: mod for mod in (
    llama_7b_paper, qwen2_5_32b, codeqwen1_5_7b, internlm2_1_8b,
    stablelm_1_6b, deepseek_v2_lite_16b, llama4_scout_17b_16e, zamba2_7b,
    rwkv6_7b, llama_3_2_vision_90b, seamless_m4t_large_v2)}

ARCH_IDS = sorted(_REGISTRY)
# the dry-run's default set (``launch/dryrun.py --arch all``), as the JAX
# package's: every config but the paper's own model
ASSIGNED_ARCH_IDS = [a for a in ARCH_IDS if a != "llama-7b-paper"]


def get_config(arch_id: str) -> ModelConfig:
    return _REGISTRY[arch_id].config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _REGISTRY[arch_id].reduced()


__all__ = [
    "ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig", "EncoderConfig",
    "LoRAConfig", "InputShape", "INPUT_SHAPES", "LONG_CONTEXT_WINDOW",
    "ARCH_IDS", "ASSIGNED_ARCH_IDS", "get_config", "get_smoke_config",
]
