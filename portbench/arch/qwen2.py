"""The program's side of a Qwen2 configuration: the port's ``ModelConfig``
and its ``DenseLM`` over the weights the benchmark made (views, no copy).
"""
from __future__ import annotations

from repro_torch.configs.base import LoRAConfig, ModelConfig
from repro_torch.models.attention import GQAAttention
from repro_torch.models.ffn import SwiGLU
from repro_torch.models.model import DenseBlock, DenseLM

from .port_common import module
from .qwen2_ref import LORA_TARGETS


def port_config(name: str, c: dict) -> ModelConfig:
    return ModelConfig(
        name=name, family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], qkv_bias=True,
        rope_theta=float(c["rope_theta"]), rmsnorm_eps=c["rms_norm_eps"],
        tie_embeddings=False, lora=LoRAConfig(targets=LORA_TARGETS),
        source=c.get("source", ""))


def port_params(cfg: ModelConfig, w: dict) -> DenseLM:
    blocks = [module(
        DenseBlock, ln1=w["ln1"][i], ln2=w["ln2"][i],
        attn=module(GQAAttention, wq=w["wq"][i], wk=w["wk"][i],
                    wv=w["wv"][i], wo=w["wo"][i], bq=w["bq"][i],
                    bk=w["bk"][i], bv=w["bv"][i]),
        ffn=module(SwiGLU, w1=w["w1"][i], w3=w["w3"][i], w2=w["w2"][i]))
        for i in range(cfg.n_layers)]
    return module(DenseLM, embed=w["embed"], ln_f=w["ln_f"],
                  lm_head=w["lm_head"], blocks=blocks)
