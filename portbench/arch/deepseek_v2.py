"""The program's side of a DeepSeek-V2 configuration: the port's
``ModelConfig`` (MLA, MoE) and its ``DenseLM`` over the benchmark's
weights. The router goes in as a float32 copy of the served weights, the
type the port's router computes in.
"""
from __future__ import annotations

from repro_torch.configs.base import (LoRAConfig, MLAConfig, ModelConfig,
                                      MoEConfig)
from repro_torch.models.attention import MLAAttention
from repro_torch.models.ffn import MoE
from repro_torch.models.model import DenseBlock, DenseLM

from .deepseek_v2_ref import LORA_TARGETS, _check
from .port_common import module


def port_config(name: str, c: dict) -> ModelConfig:
    _check(c)
    if not c["norm_topk_prob"] or c["routed_scaling_factor"] != 1 \
            or c["scoring_func"] != "softmax":
        raise ValueError("the port renormalises the top k of a softmax, "
                         "and scales nothing")
    return ModelConfig(
        name=name, family="moe", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        d_ff=c["moe_intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), rmsnorm_eps=c["rms_norm_eps"],
        tie_embeddings=False,
        mla=MLAConfig(kv_lora_rank=c["kv_lora_rank"],
                      qk_nope_head_dim=c["qk_nope_head_dim"],
                      qk_rope_head_dim=c["qk_rope_head_dim"],
                      v_head_dim=c["v_head_dim"], q_lora_rank=0),
        moe=MoEConfig(n_experts=c["n_routed_experts"],
                      top_k=c["num_experts_per_tok"],
                      d_ff_expert=c["moe_intermediate_size"],
                      n_shared_experts=c["n_shared_experts"]),
        lora=LoRAConfig(targets=LORA_TARGETS), source=c.get("source", ""))


def port_params(cfg: ModelConfig, w: dict) -> DenseLM:
    router = w["router"].float()
    blocks = [module(
        DenseBlock, ln1=w["ln1"][i], ln2=w["ln2"][i],
        attn=module(MLAAttention, wq=w["wq"][i], w_dkv=w["w_dkv"][i],
                    ln_kv=w["ln_kv"][i], w_uk=w["w_uk"][i],
                    w_uv=w["w_uv"][i], wo=w["wo"][i]),
        ffn=module(MoE, router=router[i], we1=w["we1"][i], we3=w["we3"][i],
                   we2=w["we2"][i], ws1=w["ws1"][i], ws3=w["ws3"][i],
                   ws2=w["ws2"][i]))
        for i in range(cfg.n_layers)]
    return module(DenseLM, embed=w["embed"], ln_f=w["ln_f"],
                  lm_head=w["lm_head"], blocks=blocks)
