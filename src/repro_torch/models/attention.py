"""Grouped-query attention of the PyTorch port (the GQA part of the JAX
package's ``models/attention.py``; MLA and cross-attention wait for
ROADMAP queue A item 11).

Every projection takes an optional ``lora`` hook, a callable
``lora(name, x) -> delta`` that the serving engine uses to add batched
heterogeneous-adapter deltas on the Q/K/V/O projections.

A prefill's attention (``gqa_full`` with ``positions=None``: the rows
start at position 0) of an MHA config without a sliding window runs on
the flash-attention kernel B5 (``kernels/flash.py``); GQA, windowed
attention and explicit positions run on ``common.flash_attention``.

Tensor parallel (``tp``, Megatron layout): a rank holds a contiguous
range of query heads and their kv heads, so ``wq``, ``wk``, ``wv`` are
column slices and ``wo`` a row slice. The head counts are read from the
weights, so the same code runs a full module or a rank's slice. ``o @
wo`` is then a partial sum over the rank's heads; the rank adds its
column slice of the ``o`` LoRA delta into it and one ``all_reduce_``
sums both.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from repro_torch.kernels.flash import flash_mha

from .common import (all_reduce_, apply_rope, attend_cache, dense_init,
                     flash_attention, tp_size)


def _zero_lora(name, x):
    return 0.0


class GQAAttention(nn.Module):
    """wq: (d, H*hd); wk, wv: (d, Kv*hd); wo: (H*hd, d); optional biases
    bq/bk/bv when ``cfg.qkv_bias``."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d, H, Kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim

        def w(shape):
            return nn.Parameter(dense_init(gen, shape, dtype=dtype),
                                requires_grad=False)

        self.wq = w((d, H * hd))
        self.wk = w((d, Kv * hd))
        self.wv = w((d, Kv * hd))
        self.wo = w((H * hd, d))
        if cfg.qkv_bias:
            def zeros(n):
                return nn.Parameter(torch.zeros(n, dtype=dtype,
                                                device=gen.device),
                                    requires_grad=False)
            self.bq, self.bk, self.bv = (zeros(H * hd), zeros(Kv * hd),
                                         zeros(Kv * hd))


def _qkv(cfg, p: GQAAttention, x, positions, lora, rope: bool = True):
    B, S, d = x.shape
    hd = cfg.resolved_head_dim
    H, Kv = p.wq.shape[1] // hd, p.wk.shape[1] // hd     # this rank's heads
    q = x @ p.wq + lora("q", x)
    k = x @ p.wk + lora("k", x)
    v = x @ p.wv + lora("v", x)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Kv, hd)
    v = v.reshape(B, S, Kv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p: GQAAttention, o, lora, tp):
    """o @ wo plus the ``o`` LoRA delta. At tp > 1, o holds this rank's
    heads and the delta this rank's columns of d_model: the delta goes
    into its columns of the partial sum, and one all-reduce sums both."""
    out = o @ p.wo
    delta = lora("o", o)
    if tp_size(tp) == 1:
        return out + delta
    if isinstance(delta, torch.Tensor):
        w = delta.shape[-1]
        out[..., tp.rank * w:(tp.rank + 1) * w] += delta
    return all_reduce_(out, tp)


def gqa_full(cfg, p: GQAAttention, x, positions=None, *, causal=True,
             window=0, lora: Optional[Callable] = None, tp=None):
    """Full-sequence attention. ``positions=None`` means the prefill's
    ``arange(S)``; then, when the attention is causal, unwindowed and MHA
    (H == Kv, counted on this rank), it runs on kernel B5, whose top-left
    causal mask is the prefill's. The choice reads only shapes and
    arguments. Returns (out, (k, v)) for cache seeding; k, v hold this
    rank's kv heads."""
    lora = lora or _zero_lora
    B, S = x.shape[:2]
    from_zero = positions is None
    if from_zero:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions, lora)
    if from_zero and causal and not window and q.shape[2] == k.shape[2]:
        # (B, S, H, hd) read in place; the output's memory is (B, S, H, hd)
        o = flash_mha(q.transpose(1, 2), k.transpose(1, 2),
                      v.transpose(1, 2), causal=True).transpose(1, 2)
    else:
        o = flash_attention(q, k, v, causal=causal, q_positions=positions,
                            k_positions=positions, window=window)
    return _out_proj(p, o.reshape(B, S, -1), lora, tp), (k, v)


def gqa_decode(cfg, p: GQAAttention, x, k_cache, v_cache, pos, *, window=0,
               lora: Optional[Callable] = None, tp=None):
    """Single-token decode. x: (B,1,d); caches (B,S,Kv,hd); pos: (B,) int
    current position of the new token per row. Returns (out, (k_cache,
    v_cache)) with the new token written (ring-indexed when window > 0).

    The JAX version returns new caches; this one writes the given cache
    tensors in place. JAX drops a write whose index is past the cache, as
    happens for free slots and frozen rows whose ``pos`` ran on; torch
    indexing would raise (a device-side assert on CUDA). Such rows are
    masked: they write back the value already held at the clamped slot,
    so no real slot changes."""
    lora = lora or _zero_lora
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None], lora)
    write_idx = pos % S if window else pos
    keep = (write_idx < S)[:, None, None]
    slot = write_idx.clamp(max=S - 1).long()
    bidx = torch.arange(B, device=x.device)
    k_cache[bidx, slot] = torch.where(keep, k[:, 0].to(k_cache.dtype),
                                      k_cache[bidx, slot])
    v_cache[bidx, slot] = torch.where(keep, v[:, 0].to(v_cache.dtype),
                                      v_cache[bidx, slot])
    slots = torch.arange(S, device=x.device)[None, :]
    valid = slots <= pos.clamp(max=S - 1)[:, None]
    o = attend_cache(q, k_cache, v_cache, valid)
    return _out_proj(p, o.reshape(B, 1, -1), lora, tp), (k_cache, v_cache)
