"""Plain float32 reference of a Qwen2 decoder (``model_type`` "qwen2"):
pre-norm blocks of grouped-query attention with biases on q, k and v and
RoPE over the two halves of each head, then a SwiGLU; a final RMSNorm and
an untied head. LoRA adapters add (x @ A) @ B on the q, k, v and o
projections. Keys are those of the model's ``config.json``.

It also holds the architecture's arithmetic that the benchmark's metrics
count: its weights, the matrix parameters a token meets, the attention
work of a token at a given context, and the widths of each LoRA target.
"""
from __future__ import annotations

import torch

from .ref_common import (Weights, causal_attention, logits_at, lora,
                         quantize, rmsnorm, rope, swiglu)

LORA_TARGETS = ("q", "k", "v", "o")


def dims(c: dict):
    d, H, Kv = c["hidden_size"], c["num_attention_heads"], \
        c["num_key_value_heads"]
    return d, H, Kv, d // H


def weight_specs(c: dict):
    """[(name, shape, init)]: init is the fan-in of an N(0, 1/fan_in)
    matrix, "norm" (1 + N(0, 0.1^2)) or "bias" (N(0, 0.02^2))."""
    d, H, Kv, hd = dims(c)
    L, ff, V = c["num_hidden_layers"], c["intermediate_size"], \
        c["vocab_size"]
    return [("embed", (V, d), d), ("lm_head", (d, V), d),
            ("ln_f", (d,), "norm"), ("ln1", (L, d), "norm"),
            ("ln2", (L, d), "norm"),
            ("wq", (L, d, H * hd), d), ("wk", (L, d, Kv * hd), d),
            ("wv", (L, d, Kv * hd), d), ("wo", (L, H * hd, d), H * hd),
            ("bq", (L, H * hd), "bias"), ("bk", (L, Kv * hd), "bias"),
            ("bv", (L, Kv * hd), "bias"),
            ("w1", (L, d, ff), d), ("w3", (L, d, ff), d),
            ("w2", (L, ff, d), ff)]


def lora_dims(c: dict):
    """{target: (d_in, d_out)} of the projections adapters reach."""
    d, H, Kv, hd = dims(c)
    return {"q": (d, H * hd), "k": (d, Kv * hd), "v": (d, Kv * hd),
            "o": (H * hd, d)}


def matmul_params(c: dict) -> int:
    """Matrix parameters one token multiplies: every layer's projections
    and FFN, and the head (the embedding is a lookup)."""
    d, H, Kv, hd = dims(c)
    per_layer = d * (H + 2 * Kv) * hd + H * hd * d + 3 * d * \
        c["intermediate_size"]
    return c["num_hidden_layers"] * per_layer + d * c["vocab_size"]


def attn_flops(c: dict, ctx: int) -> int:
    """Attention FLOPs of one token that attends to ``ctx`` keys: q.k and
    p.v in every layer."""
    d, H, Kv, hd = dims(c)
    return c["num_hidden_layers"] * 4 * H * hd * ctx


def forward(c: dict, tensors: dict, tokens, adapter, positions,
            control: bool = False):
    """float32 logits at ``positions`` of the sequence ``tokens`` (S,)
    under ``adapter`` ({target: {"A": (L, d_in, r), "B": (L, r,
    d_out)}}, or None), from the served weights ``tensors``. With
    ``control`` every served matrix is rounded to float8 first."""
    d, H, Kv, hd = dims(c)
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    w = Weights(tensors, control)
    S = tokens.shape[0]
    pos = torch.arange(S, device=tokens.device)
    emb = tensors["embed"][tokens.long()]
    x = (quantize(emb, -1) if control else emb.float())
    for i in range(c["num_hidden_layers"]):
        xn = rmsnorm(x, w("ln1", i, matrix=False), eps)
        q = xn @ w("wq", i) + lora(xn, adapter, "q", i, control) \
            + w("bq", i, matrix=False)
        k = xn @ w("wk", i) + lora(xn, adapter, "k", i, control) \
            + w("bk", i, matrix=False)
        v = xn @ w("wv", i) + lora(xn, adapter, "v", i, control) \
            + w("bv", i, matrix=False)
        q = rope(q.reshape(S, H, hd), pos, theta)
        k = rope(k.reshape(S, Kv, hd), pos, theta)
        v = v.reshape(S, Kv, hd)
        g = H // Kv
        o = causal_attention(q, k.repeat_interleave(g, dim=1),
                             v.repeat_interleave(g, dim=1), hd ** -0.5)
        o = o.reshape(S, H * hd)
        x = x + o @ w("wo", i) + lora(o, adapter, "o", i, control)
        xn = rmsnorm(x, w("ln2", i, matrix=False), eps)
        x = x + swiglu(xn, w("w1", i), w("w3", i), w("w2", i))
    h = rmsnorm(x, w("ln_f", matrix=False), eps)
    return logits_at(h, w, positions)
