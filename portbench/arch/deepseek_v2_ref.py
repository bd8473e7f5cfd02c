"""Plain float32 reference of a DeepSeek-V2 decoder (``model_type``
"deepseek_v2") as the configuration file states it: pre-norm blocks of
multi-head latent attention (no q compression: q = x W_q; a shared
latent c = RMSNorm(x W_dkv[:r]) and one rope key x W_dkv[r:]; per-head
keys c W_uk and values c W_uv; RoPE over the two halves of the rope part)
and a mixture of experts (a float32 softmax router over the routed
experts, the top k weights renormalised when ``norm_topk_prob`` is true,
SwiGLU experts, the shared experts as one SwiGLU of their summed width),
in every layer from ``first_k_dense_replace`` on; then a final RMSNorm
and an untied head. LoRA adapters add (x @ A) @ B on W_q ("q"), W_dkv
("k") and W_o ("o").

It also holds the architecture's arithmetic that the benchmark's metrics
count (see ``qwen2_ref``): the routed experts a token uses, not all of
them, and attention at the published head dims.
"""
from __future__ import annotations

import torch

from .ref_common import (Weights, causal_attention, logits_at, lora,
                         quantize, rmsnorm, rope, swiglu)

LORA_TARGETS = ("q", "k", "o")


def dims(c: dict):
    return (c["hidden_size"], c["num_attention_heads"], c["kv_lora_rank"],
            c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"])


def _check(c: dict) -> None:
    if c["first_k_dense_replace"] != 0 or c.get("q_lora_rank"):
        raise ValueError("this reference states every layer an expert "
                         "layer and q uncompressed")
    if c["rope_scaling_as_run"] is not None:
        raise ValueError("this reference applies plain RoPE: the file's "
                         "rope_scaling is the source's, not run")


def weight_specs(c: dict):
    """[(name, shape, init)], as ``qwen2_ref.weight_specs``."""
    _check(c)
    d, H, r, nope, rp, vd = dims(c)
    L, V = c["num_hidden_layers"], c["vocab_size"]
    E, f = c["n_routed_experts"], c["moe_intermediate_size"]
    fs = c["n_shared_experts"] * f
    return [("embed", (V, d), d), ("lm_head", (d, V), d),
            ("ln_f", (d,), "norm"), ("ln1", (L, d), "norm"),
            ("ln2", (L, d), "norm"), ("ln_kv", (L, r), "norm"),
            ("wq", (L, d, H * (nope + rp)), d), ("w_dkv", (L, d, r + rp), d),
            ("w_uk", (L, r, H * nope), r), ("w_uv", (L, r, H * vd), r),
            ("wo", (L, H * vd, d), H * vd), ("router", (L, d, E), d),
            ("we1", (L, E, d, f), d), ("we3", (L, E, d, f), d),
            ("we2", (L, E, f, d), f), ("ws1", (L, d, fs), d),
            ("ws3", (L, d, fs), d), ("ws2", (L, fs, d), fs)]


def lora_dims(c: dict):
    d, H, r, nope, rp, vd = dims(c)
    return {"q": (d, H * (nope + rp)), "k": (d, r + rp), "o": (H * vd, d)}


def matmul_params(c: dict) -> int:
    """Matrix parameters one token multiplies: the attention projections
    (W_uk and W_uv once for the token's own latent), the router, the
    top-k routed and the shared experts, and the head."""
    d, H, r, nope, rp, vd = dims(c)
    attn = d * H * (nope + rp) + d * (r + rp) + r * H * (nope + vd) \
        + H * vd * d
    f = c["moe_intermediate_size"]
    ffn = d * c["n_routed_experts"] + 3 * d * f * (
        c["num_experts_per_tok"] + c["n_shared_experts"])
    return c["num_hidden_layers"] * (attn + ffn) + d * c["vocab_size"]


def attn_flops(c: dict, ctx: int) -> int:
    d, H, r, nope, rp, vd = dims(c)
    return c["num_hidden_layers"] * 2 * H * (nope + rp + vd) * ctx


def _moe(c, w: Weights, i: int, x):
    E, K = c["n_routed_experts"], c["num_experts_per_tok"]
    probs = torch.softmax(x @ w("router", i, matrix=False), dim=-1)
    topw, topi = torch.topk(probs, K, dim=-1)
    if c["norm_topk_prob"]:
        topw = topw / topw.sum(-1, keepdim=True)
    out = swiglu(x, w("ws1", i), w("ws3", i), w("ws2", i))
    for e in range(E):
        rows, k = (topi == e).nonzero(as_tuple=True)
        if rows.numel():
            y = swiglu(x[rows], w("we1", i, e), w("we3", i, e),
                       w("we2", i, e))
            out = out.index_add(0, rows, y * topw[rows, k, None])
    return out


def forward(c: dict, tensors: dict, tokens, adapter, positions,
            control: bool = False):
    """float32 logits at ``positions`` of ``tokens`` (S,), as
    ``qwen2_ref.forward``."""
    _check(c)
    d, H, r, nope, rp, vd = dims(c)
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    w = Weights(tensors, control)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    emb = tensors["embed"][tokens.long()]
    x = (quantize(emb, -1) if control else emb.float())
    for i in range(c["num_hidden_layers"]):
        xn = rmsnorm(x, w("ln1", i, matrix=False), eps)
        q = (xn @ w("wq", i) + lora(xn, adapter, "q", i, control)).reshape(
            S, H, nope + rp)
        q = torch.cat([q[..., :nope], rope(q[..., nope:], pos, theta)], -1)
        dkv = xn @ w("w_dkv", i) + lora(xn, adapter, "k", i, control)
        lat = rmsnorm(dkv[:, :r], w("ln_kv", i, matrix=False), eps)
        kr = rope(dkv[:, None, r:], pos, theta).expand(S, H, rp)
        kn = (lat @ w("w_uk", i)).reshape(S, H, nope)
        v = (lat @ w("w_uv", i)).reshape(S, H, vd)
        o = causal_attention(q, torch.cat([kn, kr], -1), v,
                             (nope + rp) ** -0.5).reshape(S, H * vd)
        x = x + o @ w("wo", i) + lora(o, adapter, "o", i, control)
        x = x + _moe(c, w, i, rmsnorm(x, w("ln2", i, matrix=False), eps))
    h = rmsnorm(x, w("ln_f", matrix=False), eps)
    return logits_at(h, w, positions)
