"""Model assembly of the PyTorch port for the dense family: init, prefill
and decode (the dense branches of the JAX package's ``models/model.py``).

Parameters live in ``nn.Module``s (``DenseLM`` > ``DenseBlock`` >
``GQAAttention`` / ``SwiGLU``) in the JAX layout, weights (d_in, d_out)
used as ``x @ w``. The layer stack is a Python loop over ``blocks`` where
JAX scans. Cache dict keys, as in the JAX package:
  pos  : (B,) int32 — tokens currently in the cache per row
  k, v : (L, B, S, Kv, hd) self-attention KV
``decode_step`` writes each layer's new K/V into the given cache tensors
in place (JAX returns new arrays) and returns a dict with a new ``pos``.

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

from .attention import GQAAttention, gqa_decode, gqa_full
from .common import dense_init, rmsnorm, tp_size
from .ffn import SwiGLU


def _check_family(cfg) -> None:
    if cfg.family != "dense" or cfg.moe is not None or cfg.mla is not None \
            or cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family without MoE or MLA is "
            "ported; the other families are ROADMAP queue A item 11")


class DenseBlock(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = nn.Parameter(torch.ones(d, dtype=dtype, device=gen.device),
                                requires_grad=False)
        self.ln2 = nn.Parameter(torch.ones(d, dtype=dtype, device=gen.device),
                                requires_grad=False)
        self.attn = GQAAttention(cfg, gen, dtype)
        self.ffn = SwiGLU(d, cfg.d_ff, gen, dtype)


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


def _dense_block_full(cfg, bp: DenseBlock, x, window, lora, tp):
    # positions None: the prefill's arange(S), which lets MHA attention
    # take kernel B5
    h, kv = gqa_full(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                     window=window, lora=lora, tp=tp)
    x = x + h
    f = bp.ffn(rmsnorm(x, bp.ln2, cfg.rmsnorm_eps), tp)
    return x + f, kv


def _dense_block_decode(cfg, bp: DenseBlock, x, kc, vc, pos, window, lora,
                        tp):
    h, _ = gqa_decode(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                      kc, vc, pos, window=window, lora=lora, tp=tp)
    x = x + h
    return x + bp.ffn(rmsnorm(x, bp.ln2, cfg.rmsnorm_eps), tp)


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
    Kv, hd = cfg.n_kv_heads // tp_size(tp), cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, Kv, hd)
    return {"pos": torch.zeros(batch, dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


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
        x, (k, v) = _dense_block_full(cfg, bp, x, window, lora, tp)
        # one layer at a time into the cache (no stacked (L, ...) copy)
        _write_prefill_kv(k[None], cache["k"][i:i + 1], window)
        _write_prefill_kv(v[None], cache["v"][i:i + 1], window)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    h_last = rmsnorm(x[:, -1], params.ln_f, cfg.rmsnorm_eps)
    return h_last.float() @ lm_head(cfg, params).float(), cache


def decode_step(cfg, params: DenseLM, cache, tokens, *, bank=None,
                lora_idx=None, window: Optional[int] = None,
                lora_kernel="einsum", tp=None):
    """One decode step. tokens: (B,) int. Returns (logits (B,V), cache):
    the K/V tensors of ``cache`` are updated in place, ``pos`` is new."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    pos = cache["pos"]
    x = _embed(params, tokens[:, None])
    for i, bp in enumerate(params.blocks):
        lora = make_lora_cb(bank_layer(bank, i), lora_idx,
                            kernel=lora_kernel, tp=tp)
        x = _dense_block_decode(cfg, bp, x, cache["k"][i], cache["v"][i],
                                pos, window, lora, tp)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    h_last = rmsnorm(x[:, 0], params.ln_f, cfg.rmsnorm_eps)
    return h_last.float() @ lm_head(cfg, params).float(), new_cache
