"""Attention of the PyTorch port: grouped-query attention, DeepSeek-V2's
multi-head latent attention (MLA) and cross-attention (the VLM's image
layers, the encoder-decoder's decoder), the JAX package's
``models/attention.py``.

Every projection takes an optional ``lora`` hook, a callable
``lora(name, x) -> delta`` that the serving engine uses to add batched
heterogeneous-adapter deltas on the Q/K/V/O projections.

MHA (H == Kv) from position 0 without a sliding window runs on the
flash-attention kernel B5 (``kernels/flash.py``): a prefill's causal
attention and the audio encoder's bidirectional one (``gqa_full`` with
``positions=None``, causal or not), and cross-attention over the
encoder's memory at S > 1 (non-causal, Sq = S, Sk = M). GQA, windowed
attention and explicit positions run on ``common.flash_attention``, and
so does MLA's (its rope key is shared by the heads, and its q.k head dim
is not v's), as in the JAX package. The route reads only shapes and
arguments, and ``flash_kernel``: the full-sequence forms take it, and
``flash_kernel=False`` sends every shape to ``common.flash_attention``,
the reference's plain path, which autograd differentiates. Training
passes it (``model.forward``): B5 has no backward, and its wrapper
refuses a tensor that requires grad.

Products take the promoted type of their operands (``common.mm``), as
JAX's do: the engine's frontend is fp32, so over bf16 weights the audio
encoder, its memory and the cross K/V are fp32, and B5 runs its fp32
kernel on them; the decoder's hidden state stays in the weights' type.

Tensor parallel (``tp``, Megatron layout): a rank holds a contiguous
range of query heads and the kv heads they read, so ``wq``, ``wk``,
``wv`` are column slices and ``wo`` a row slice. Where tp does not
divide the kv heads, each rank holds ``local_kv_heads`` of them, the
JAX ``_regroup_plan``'s duplicates: the rank's query heads then still
group evenly over its kv heads, and the JAX plan's zero-padded queries
are not needed (n_heads divisible by tp makes every group whole). The
head counts are read from the weights, so the same code runs a full
module or a rank's slice, GQA, MLA and cross-attention alike. ``o @ wo``
is then a partial sum over the rank's heads; the rank adds its column
slice of the ``o`` LoRA delta into it and one ``all_reduce_`` sums both.
MLA's ``w_dkv``, ``ln_kv`` and latent cache are whole on every rank; its
``k`` adapter's delta comes back from the LoRA hook at full width
(``lora.batched``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

# B5 through its operator: the wrapper's call, which a dispatch mode sees
# by name and which gives shapes on meta (kernels/flash.py:flash_mha_op)
from repro_torch.kernels.flash import flash_mha_op as flash_mha

from .common import (NEG_INF, apply_rope, attend_cache, dense_init,
                     flash_attention, mm, rmsnorm, row_parallel_out)


def _zero_lora(name, x):
    return 0.0


def kv_regroup(H: int, Kv: int, n: int) -> int:
    """The JAX ``_regroup_plan``'s ``rep``: the fewest duplicates of each
    kv head for which the Kv * rep "virtual" kv heads divide evenly over
    n ranks (1 when n divides Kv). With n | H, rep divides G = H / Kv, so
    every virtual head keeps G / rep whole query heads."""
    rep = 1
    while (Kv * rep) % n:
        rep += 1
    return rep


def local_kv_heads(cfg, n: int) -> int:
    """The kv heads one of n ranks holds: Kv / n, or after the regroup
    Kv * rep / n (``kv_regroup``)."""
    Kv = cfg.n_kv_heads
    return Kv * kv_regroup(cfg.n_heads, Kv, n) // n


def _projections(module, cfg, gen, dtype):
    """wq: (d, H*hd); wk, wv: (d, Kv*hd); wo: (H*hd, d) on ``module``."""
    d, H, Kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    for name, shape in (("wq", (d, H * hd)), ("wk", (d, Kv * hd)),
                        ("wv", (d, Kv * hd)), ("wo", (H * hd, d))):
        setattr(module, name, nn.Parameter(
            dense_init(gen, shape, dtype=dtype), requires_grad=False))


class GQAAttention(nn.Module):
    """wq: (d, H*hd); wk, wv: (d, Kv*hd); wo: (H*hd, d); optional biases
    bq/bk/bv when ``cfg.qkv_bias``."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        H, Kv = cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        _projections(self, cfg, gen, dtype)
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
    q = mm(x, p.wq) + lora("q", x)
    k = mm(x, p.wk) + lora("k", x)
    v = mm(x, p.wv) + lora("v", x)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Kv, hd)
    v = v.reshape(B, S, Kv, hd)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _out_proj(p, o, lora, tp):
    """o @ wo plus the ``o`` LoRA delta. At tp > 1, o holds this rank's
    heads and the delta this rank's columns of d_model: the delta goes
    into its columns of the partial sum, and one all-reduce sums both."""
    return row_parallel_out(mm(o, p.wo), lora("o", o), tp)


def gqa_full(cfg, p: GQAAttention, x, positions=None, *, causal=True,
             window=0, lora: Optional[Callable] = None, tp=None,
             flash_kernel: bool = True):
    """Full-sequence attention. ``positions=None`` means the prefill's
    (or the audio encoder's) ``arange(S)``; then, when the attention is
    unwindowed and MHA (H == Kv, counted on this rank) and
    ``flash_kernel`` is True (serving), it runs on kernel B5, causal
    (whose top-left mask is the prefill's) or not. ``flash_kernel=False``
    (training) runs every shape on ``common.flash_attention``, which
    autograd differentiates. The choice reads only shapes and arguments.
    Returns (out, (k, v)) for cache seeding; k, v hold this rank's kv
    heads."""
    lora = lora or _zero_lora
    B, S = x.shape[:2]
    from_zero = positions is None
    if from_zero:
        positions = torch.arange(S, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions, lora)
    if flash_kernel and from_zero and not window and \
            q.shape[2] == k.shape[2]:
        o = _flash_mha(q, k, v, causal)
    else:
        o = flash_attention(q, k, v, causal=causal, q_positions=positions,
                            k_positions=positions, window=window)
    return _out_proj(p, o.reshape(B, S, -1), lora, tp), (k, v)


def _flash_mha(q, k, v, causal):
    """B5 on (B, S, H, hd) tensors, read in place (the output's memory is
    (B, S, H, hd) too), in the promoted type of q and k; the output in
    q's type."""
    dt = torch.promote_types(q.dtype, k.dtype)
    o = flash_mha(q.transpose(1, 2).to(dt), k.transpose(1, 2).to(dt),
                  v.transpose(1, 2).to(dt), causal=causal)
    return o.transpose(1, 2).to(q.dtype)


def _write_token(cache, write_idx, new):
    """Row b's ``new[b]`` into slot ``write_idx[b]`` of ``cache`` (B, S,
    ...), in place. JAX drops a write whose index is past the cache, as
    happens for free slots and frozen rows whose ``pos`` ran on; torch
    indexing would raise (a device-side assert on CUDA). Such rows write
    back the value already held at the clamped slot, so no real slot
    changes."""
    B, S = cache.shape[:2]
    keep = (write_idx < S).reshape((B,) + (1,) * (cache.dim() - 2))
    slot = write_idx.clamp(max=S - 1).long()
    bidx = torch.arange(B, device=cache.device)
    cache[bidx, slot] = torch.where(keep, new.to(cache.dtype),
                                    cache[bidx, slot])


def gqa_decode(cfg, p: GQAAttention, x, k_cache, v_cache, pos, *, window=0,
               lora: Optional[Callable] = None, tp=None):
    """Single-token decode. x: (B,1,d); caches (B,S,Kv,hd); pos: (B,) int
    current position of the new token per row. Returns (out, (k_cache,
    v_cache)) with the new token written (ring-indexed when window > 0).

    The JAX version returns new caches; this one writes the given cache
    tensors in place, masking rows past the cache (``_write_token``)."""
    lora = lora or _zero_lora
    B = x.shape[0]
    S = k_cache.shape[1]
    q, k, v = _qkv(cfg, p, x, pos[:, None], lora)
    write_idx = pos % S if window else pos
    _write_token(k_cache, write_idx, k[:, 0])
    _write_token(v_cache, write_idx, v[:, 0])
    slots = torch.arange(S, device=x.device)[None, :]
    valid = slots <= pos.clamp(max=S - 1)[:, None]
    o = attend_cache(q, k_cache, v_cache, valid)
    return _out_proj(p, o.reshape(B, 1, -1), lora, tp), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): a compressed cache of (c_kv, k_rope)
# ---------------------------------------------------------------------------


class MLAAttention(nn.Module):
    """wq: (d, H*(nope+rope)); w_dkv: (d, kv_lora_rank+rope); ln_kv:
    (kv_lora_rank,); w_uk: (kv_lora_rank, H*nope); w_uv: (kv_lora_rank,
    H*v_head_dim); wo: (H*v_head_dim, d). At tp > 1 ``wq``, ``w_uk``,
    ``w_uv`` hold the rank's heads' columns and ``wo`` their rows."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        m = cfg.mla
        d, H = cfg.d_model, cfg.n_heads
        qd = m.qk_nope_head_dim + m.qk_rope_head_dim

        def w(shape):
            return nn.Parameter(dense_init(gen, shape, dtype=dtype),
                                requires_grad=False)

        self.wq = w((d, H * qd))
        self.w_dkv = w((d, m.kv_lora_rank + m.qk_rope_head_dim))
        self.ln_kv = nn.Parameter(torch.ones(m.kv_lora_rank, dtype=dtype,
                                             device=gen.device),
                                  requires_grad=False)
        self.w_uk = w((m.kv_lora_rank, H * m.qk_nope_head_dim))
        self.w_uv = w((m.kv_lora_rank, H * m.v_head_dim))
        self.wo = w((H * m.v_head_dim, d))


def _mla_q(cfg, p: MLAAttention, x, positions, lora):
    m = cfg.mla
    B, S, _ = x.shape
    q = (x @ p.wq + lora("q", x)).reshape(
        B, S, -1, m.qk_nope_head_dim + m.qk_rope_head_dim)
    qn, qr = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return torch.cat([qn, apply_rope(qr, positions, cfg.rope_theta)], dim=-1)


def _mla_ckv(cfg, p: MLAAttention, x, positions, lora):
    """(c (B,S,kv_lora_rank) normed, kr (B,S,1,rope) rotated). Only the
    ``k`` adapter reaches MLA, on ``w_dkv``: the reference never applies
    ``v`` here, and neither does the port (ROADMAP C9). Replicated at tp
    > 1: the hook gives the ``k`` delta at full width."""
    m = cfg.mla
    B, S, _ = x.shape
    dkv = x @ p.w_dkv + lora("k", x)
    c, kr = dkv.split([m.kv_lora_rank, m.qk_rope_head_dim], dim=-1)
    c = rmsnorm(c, p.ln_kv, cfg.rmsnorm_eps)
    kr = apply_rope(kr.reshape(B, S, 1, m.qk_rope_head_dim), positions,
                    cfg.rope_theta)
    return c, kr


def _mla_expand(cfg, p: MLAAttention, c):
    """The compressed cache expanded into per-head K_nope and V, in the
    promoted type of c and the weights (JAX promotes an fp32 cache times
    bf16 weights to fp32; torch would refuse the mixed product)."""
    m = cfg.mla
    B, S, _ = c.shape
    dt = torch.promote_types(c.dtype, p.w_uk.dtype)
    c = c.to(dt)
    kn = (c @ p.w_uk.to(dt)).reshape(B, S, -1, m.qk_nope_head_dim)
    v = (c @ p.w_uv.to(dt)).reshape(B, S, -1, m.v_head_dim)
    return kn, v


def mla_full(cfg, p: MLAAttention, x, positions=None, *, causal=True,
             window=0, lora: Optional[Callable] = None, tp=None,
             flash_kernel: bool = True):
    """Full-sequence MLA; ``positions=None`` means ``arange(S)``. The score
    is q_nope.k_nope + q_rope.k_rope, the shared rope key scored as
    ``flash_attention``'s ``extra_qk``: every call is on the plain path,
    so ``flash_kernel`` (``gqa_full``'s) changes nothing here. Returns
    (out, (c, kr)) for cache seeding: c (B,S,kv_lora_rank), kr
    (B,S,rope)."""
    lora = lora or _zero_lora
    m = cfg.mla
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q = _mla_q(cfg, p, x, positions, lora)
    c, kr = _mla_ckv(cfg, p, x, positions, lora)
    kn, v = _mla_expand(cfg, p, c)
    qn, qr = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    o = flash_attention(qn, kn, v, causal=causal, q_positions=positions,
                        k_positions=positions, window=window, scale=scale,
                        extra_qk=(qr, kr[:, :, 0, :]))
    return _out_proj(p, o.reshape(B, S, -1), lora, tp), (c, kr[:, :, 0, :])


def mla_decode(cfg, p: MLAAttention, x, c_cache, kr_cache, pos, *,
               window=0, lora: Optional[Callable] = None,
               absorbed: bool = False, tp=None):
    """Single-token MLA decode. c_cache: (B,S,kv_lora_rank); kr_cache:
    (B,S,rope), both written in place as ``gqa_decode`` writes its caches.

    ``absorbed=False`` (the engine's) expands the whole cached latent into
    per-head K/V each step; ``absorbed=True`` folds W_UK into the query and
    W_UV into the output (score = (q_nope @ W_UK^T) . c), never making
    per-head K/V. Returns (out, (c_cache, kr_cache))."""
    lora = lora or _zero_lora
    m = cfg.mla
    B = x.shape[0]
    S = c_cache.shape[1]
    q = _mla_q(cfg, p, x, pos[:, None], lora)                # (B,1,H,qd)
    H = q.shape[2]                                           # this rank's
    c_t, kr_t = _mla_ckv(cfg, p, x, pos[:, None], lora)
    write_idx = pos % S if window else pos
    _write_token(c_cache, write_idx, c_t[:, 0])
    _write_token(kr_cache, write_idx, kr_t[:, 0, 0])
    slots = torch.arange(S, device=x.device)[None, :]
    valid = slots <= pos.clamp(max=S - 1)[:, None]
    qn, qr = q[:, 0].split([m.qk_nope_head_dim, m.qk_rope_head_dim],
                           dim=-1)                           # (B,H,*)
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    if absorbed:
        c32 = c_cache.float()
        wuk = p.w_uk.reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
        q_lat = torch.einsum("bhn,rhn->bhr", qn.float(), wuk.float())
        s = torch.einsum("bhr,bsr->bhs", q_lat, c32)
        s = s + torch.einsum("bhr,bsr->bhs", qr.float(), kr_cache.float())
        s = torch.where(valid[:, None, :], s * scale, NEG_INF)
        o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, dim=-1), c32)
        wuv = p.w_uv.reshape(m.kv_lora_rank, H, m.v_head_dim)
        o = torch.einsum("bhr,rhv->bhv", o_lat, wuv.float())
        o = o.reshape(B, 1, H * m.v_head_dim).to(x.dtype)
    else:
        kn, v = _mla_expand(cfg, p, c_cache)                 # (B,S,H,*)
        dt = torch.promote_types(kn.dtype, kr_cache.dtype)
        k = torch.cat([kn.to(dt), kr_cache[:, :, None, :].to(dt).expand(
            B, S, H, m.qk_rope_head_dim)], dim=-1)
        o = attend_cache(q, k, v, valid, scale=scale).reshape(B, 1, -1)
    return _out_proj(p, o, lora, tp), (c_cache, kr_cache)


# ---------------------------------------------------------------------------
# Cross-attention (the VLM's image layers, the encoder-decoder's decoder)
# ---------------------------------------------------------------------------


class CrossAttention(nn.Module):
    """wq: (d, H*hd); wk, wv: (d, Kv*hd); wo: (H*hd, d): no bias, no
    RoPE (the JAX ``init_cross_attn``); split by head at tp > 1 as
    ``GQAAttention`` is."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        _projections(self, cfg, gen, dtype)


def cross_kv(cfg, p: CrossAttention, memory):
    """The cross-attention's K/V of ``memory`` (B, M, d), each (B, M, Kv,
    hd), computed once at prefill, in the promoted type of memory and
    the weights."""
    B, M, _ = memory.shape
    hd = cfg.resolved_head_dim
    Kv = p.wk.shape[1] // hd
    return (mm(memory, p.wk).reshape(B, M, Kv, hd),
            mm(memory, p.wv).reshape(B, M, Kv, hd))


def cross_attend(cfg, p: CrossAttention, x, k, v, lora=None, tp=None,
                 flash_kernel: bool = True):
    """x: (B, S, d) queries; k, v: (B, M, Kv, hd) from ``cross_kv`` (or
    the cache). Non-causal, no RoPE. At S = 1 ``attend_cache`` with every
    key valid; at S > 1 MHA runs on B5 non-causal (Sq = S, Sk = M) when
    ``flash_kernel`` is True (serving), GQA and every shape with
    ``flash_kernel=False`` (training) on ``flash_attention(causal=False)``
    over ``arange(S)`` and ``arange(M)``. The output is in the type of x's product with the
    weights. At tp > 1 k, v hold the rank's kv heads and the output
    projection ends in one all-reduce."""
    lora = lora or _zero_lora
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = (mm(x, p.wq) + lora("q", x)).reshape(B, S, -1, hd)
    M = k.shape[1]
    if S == 1:
        valid = torch.ones((B, M), dtype=torch.bool, device=x.device)
        o = attend_cache(q, k, v, valid)
    elif flash_kernel and q.shape[2] == k.shape[2]:
        o = _flash_mha(q, k, v, causal=False)
    else:
        o = flash_attention(q, k, v, causal=False,
                            q_positions=torch.arange(S, device=x.device),
                            k_positions=torch.arange(M, device=x.device))
    return _out_proj(p, o.reshape(B, S, -1), lora, tp)
