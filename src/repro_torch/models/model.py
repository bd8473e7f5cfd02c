"""Model assembly of the PyTorch port for the dense and MoE families:
init, prefill and decode (the ``dense``/``moe`` branches of the JAX
package's ``models/model.py``, which run both on one runner).

Parameters live in ``nn.Module``s (``DenseLM`` > ``DenseBlock`` >
``GQAAttention`` or ``MLAAttention``, ``SwiGLU`` or ``MoE``, chosen as
the JAX ``_init_dense_block`` chooses: MLA when ``cfg.mla`` is set, MoE
when ``cfg.moe`` is) in the JAX layout, weights (d_in, d_out) used as
``x @ w``. The layer stack is a Python loop over ``blocks`` where JAX
scans. Cache dict keys, as in the JAX package:
  pos   : (B,) int32 — tokens currently in the cache per row
  k, v  : (L, B, S, Kv, hd) self-attention KV
  c, kr : (L, B, S, kv_lora_rank) / (L, B, S, rope) MLA's compressed
          cache, in place of k and v
``decode_step`` writes each layer's new entries into the given cache
tensors in place (JAX returns new arrays) and returns a dict with a new
``pos``. Serving ignores the MoE layers' balance loss, as the JAX
prefill and decode do.

``tp`` (a ``launch.mesh.TensorParallel``, optional) runs a rank of a
tensor-parallel model: ``params`` is the rank's slice
(``serving.sharding.EngineSharding.shard_params``), the cache holds its
kv heads, and the LoRA bank its co-sharded slice. Embedding, norms and
``lm_head`` are replicated, and the hidden state after every all-reduce
is the same on every rank, so every rank computes the same logits.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.lora.batched import make_lora_cb

from .attention import (GQAAttention, MLAAttention, gqa_decode, gqa_full,
                        mla_decode, mla_full)
from .common import dense_init, rmsnorm, tp_size
from .ffn import MoE, SwiGLU, moe_ffn


def _check_family(cfg) -> None:
    if cfg.family not in ("dense", "moe") or cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the dense "
            "and MoE families are, the others are ROADMAP queue A item 10")


def _cache_keys(cfg):
    """The two per-layer cache entries of an attention layer."""
    return ("c", "kr") if cfg.mla is not None else ("k", "v")


class DenseBlock(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=gen.device),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=gen.device),
                                requires_grad=False)
        self.attn = (MLAAttention if cfg.mla is not None else GQAAttention)(
            cfg, gen, dtype)
        self.ffn = MoE(cfg, gen, dtype) if cfg.moe is not None else \
            SwiGLU(d, cfg.d_ff, gen, dtype)


class DenseLM(nn.Module):
    """embed: (V, d); ln_f: (d,); lm_head: (d, V) unless tied; blocks."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        _check_family(cfg)
        d, V = cfg.d_model, cfg.vocab_size
        self.embed = nn.Parameter(dense_init(gen, (V, d), fan_in=d,
                                             dtype=dtype),
                                  requires_grad=False)
        self.ln_f = nn.Parameter(torch.ones(d, dtype=dtype,
                                            device=gen.device),
                                 requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(dense_init(gen, (d, V), dtype=dtype),
                                        requires_grad=False)
        self.blocks = nn.ModuleList(DenseBlock(cfg, gen, dtype)
                                    for _ in range(cfg.n_layers))


def init_params(cfg, seed: int = 0, *, dtype=torch.float32,
                device="cuda") -> DenseLM:
    """Random base weights from one ``torch.Generator`` on ``device``
    (not the JAX package's numbers: tests carry weights across with
    ``repro_torch.bridge``)."""
    _check_family(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    return DenseLM(cfg, gen, dtype)


def lm_head(cfg, params: DenseLM):
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def bank_layer(bank, i: int):
    """Layer ``i`` of a padded bank dict or of each bucket's dict (views)."""
    if bank is None:
        return None
    if isinstance(bank, (tuple, list)):
        return tuple(bank_layer(b, i) for b in bank)
    return {t: {"A": w["A"][i], "B": w["B"][i]} for t, w in bank.items()}


def _ffn(cfg, bp: DenseBlock, x, tp):
    xn = rmsnorm(x, bp.ln2, cfg.rmsnorm_eps)
    if cfg.moe is not None:
        return moe_ffn(cfg, bp.ffn, xn)[0]
    return bp.ffn(xn, tp)


def _dense_block_full(cfg, bp: DenseBlock, x, window, lora, tp):
    # positions None: the prefill's arange(S), which lets MHA attention
    # take kernel B5
    xn = rmsnorm(x, bp.ln1, cfg.rmsnorm_eps)
    if cfg.mla is not None:
        h, kv = mla_full(cfg, bp.attn, xn, window=window, lora=lora)
    else:
        h, kv = gqa_full(cfg, bp.attn, xn, window=window, lora=lora, tp=tp)
    x = x + h
    return x + _ffn(cfg, bp, x, tp), kv


def _dense_block_decode(cfg, bp: DenseBlock, x, kc, vc, pos, window, lora,
                        tp, mla_absorbed=False):
    xn = rmsnorm(x, bp.ln1, cfg.rmsnorm_eps)
    if cfg.mla is not None:
        h, _ = mla_decode(cfg, bp.attn, xn, kc, vc, pos, window=window,
                          lora=lora, absorbed=mla_absorbed)
    else:
        h, _ = gqa_decode(cfg, bp.attn, xn, kc, vc, pos, window=window,
                          lora=lora, tp=tp)
    x = x + h
    return x + _ffn(cfg, bp, x, tp)


def _embed(params: DenseLM, tokens):
    return params.embed[tokens.long()]


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device="cuda", tp=None):
    """Zeroed cache dict. max_len should already account for any sliding
    window (callers pass min(seq, window)). At tp > 1 it holds this rank's
    n_kv_heads / tp kv heads (the JAX package's kv-head-sharded
    "baseline" cache layout), and no full cache is ever made."""
    _check_family(cfg)
    dev = resolve_device(device)
    lead = (cfg.n_layers, batch, max_len)
    if cfg.mla is not None:
        m = cfg.mla
        shapes = (lead + (m.kv_lora_rank,), lead + (m.qk_rope_head_dim,))
    else:
        kv = lead + (cfg.n_kv_heads // tp_size(tp), cfg.resolved_head_dim)
        shapes = (kv, kv)
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    for name, shape in zip(_cache_keys(cfg), shapes):
        cache[name] = torch.zeros(shape, dtype=dtype, device=dev)
    return cache


def _write_prefill_kv(kvs, cache_arr, window):
    """kvs: (L, B, S, ...) computed at prefill; written in place into
    cache_arr (L, B, Smax, ...), honoring the ring layout when window > 0."""
    S = kvs.shape[2]
    Smax = cache_arr.shape[2]
    if window and S > Smax:
        # keep the last `Smax` entries at their ring slots
        slots = torch.arange(S - Smax, S, device=kvs.device) % Smax
        cache_arr[:, :, slots] = kvs[:, :, S - Smax:].to(cache_arr.dtype)
    else:
        n = min(S, Smax)
        cache_arr[:, :, :n] = kvs[:, :, :n].to(cache_arr.dtype)
    return cache_arr


def prefill(cfg, params: DenseLM, tokens, *, bank=None, lora_idx=None,
            cache_len: Optional[int] = None, window: Optional[int] = None,
            cache_dtype=None, lora_kernel="einsum", tp=None):
    """Prefill a batch of same-length rows. Returns (last_logits (B,V),
    cache)."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    B, S = tokens.shape
    cache_len = cache_len or (min(S, window) if window else S)
    x = _embed(params, tokens)
    cache = init_cache(cfg, B, cache_len, cache_dtype or params.embed.dtype,
                       device=tokens.device, tp=tp)
    for i, bp in enumerate(params.blocks):
        lora = make_lora_cb(bank_layer(bank, i), lora_idx,
                            kernel=lora_kernel, tp=tp)
        x, kv = _dense_block_full(cfg, bp, x, window, lora, tp)
        # one layer at a time into the cache (no stacked (L, ...) copy)
        for name, t in zip(_cache_keys(cfg), kv):
            _write_prefill_kv(t[None], cache[name][i:i + 1], window)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    h_last = rmsnorm(x[:, -1], params.ln_f, cfg.rmsnorm_eps)
    return h_last.float() @ lm_head(cfg, params).float(), cache


def decode_step(cfg, params: DenseLM, cache, tokens, *, bank=None,
                lora_idx=None, window: Optional[int] = None,
                mla_absorbed=False, lora_kernel="einsum", tp=None):
    """One decode step. tokens: (B,) int. Returns (logits (B,V), cache):
    the K/V (or c/kr) tensors of ``cache`` are updated in place, ``pos``
    is new. ``mla_absorbed`` selects MLA's absorbed decode (the engine's
    is the naive expand)."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    pos = cache["pos"]
    ka, kb = _cache_keys(cfg)
    x = _embed(params, tokens[:, None])
    for i, bp in enumerate(params.blocks):
        lora = make_lora_cb(bank_layer(bank, i), lora_idx,
                            kernel=lora_kernel, tp=tp)
        x = _dense_block_decode(cfg, bp, x, cache[ka][i], cache[kb][i],
                                pos, window, lora, tp, mla_absorbed)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    h_last = rmsnorm(x[:, 0], params.ln_f, cfg.rmsnorm_eps)
    return h_last.float() @ lm_head(cfg, params).float(), new_cache
