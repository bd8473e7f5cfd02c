"""Model assembly of the PyTorch port: init, prefill and decode for every
family of the JAX package's ``models/model.py`` (dense, MoE, hybrid, SSM,
VLM and audio).

Parameters live in ``nn.Module``s in the JAX layout, weights (d_in,
d_out) used as ``x @ w``, each module's attributes named as the JAX
tree's leaves:
  * ``DenseLM`` > ``DenseBlock`` > ``GQAAttention`` or ``MLAAttention``,
    ``SwiGLU`` or ``MoE``, chosen as the JAX ``_init_dense_block``
    chooses (MLA when ``cfg.mla`` is set, MoE when ``cfg.moe`` is);
  * ``HybridLM`` (zamba2): ``mamba_blocks`` (``ssm.Mamba2``, one a
    layer) and one ``shared_attn`` ``DenseBlock`` applied before every
    segment of ``cfg.attn_every`` Mamba2 layers (``_hybrid_segments``);
  * ``RWKVLM``: ``blocks`` of ``ssm.RWKV6``;
  * ``VisionLM`` (llama-3.2-vision): ``self_blocks`` (``DenseBlock``)
    and ``cross_blocks`` (``CrossBlock``: cross-attention and SwiGLU,
    each behind a tanh gate that is 0 at init, so the block is the
    identity until its gates move). Period p runs ``self_blocks[4p ..
    4p+3]`` (``cross_attn_every`` - 1 of them), then ``cross_blocks[p]``;
    self-attention cache entry 4p + j is period p's layer j;
  * ``EncDecLM`` (seamless-m4t): the bidirectional encoder
    ``enc_blocks`` (``DenseBlock``) with ``enc_ln_f`` over the frame
    embeddings, then ``dec_blocks`` (``EncDecBlock``: causal
    self-attention, cross-attention over the encoder's memory, SwiGLU).
The layer stack is a Python loop where JAX scans. Cache dict keys, as in
the JAX package:
  pos   : (B,) int32 — tokens currently in the cache per row
  k, v  : (L_attn, B, S, Kv, hd) self-attention KV (L_attn =
          ``n_attn_applications``: every layer, or every application of
          the hybrid's shared block)
  c, kr : (L, B, S, kv_lora_rank) / (L, B, S, rope) MLA's compressed
          cache, in place of k and v
  xk, xv : (L_cross, B, M, Kv, hd) cross-attention K/V of the frontend
          (VLM) or of the encoder's memory (audio), computed at prefill
  ssm   : (L, B, H, hd, N) Mamba2 state
  wkv, x_tm, x_cm : RWKV-6 state (L, B, H, hd, hd) fp32 and the token
          shifts (L, B, d)
``prefill`` and ``decode_step`` write each layer's entries into the cache
tensors in place (JAX returns new arrays) and return a dict with a new
``pos``. Serving ignores the MoE layers' balance loss, as the JAX prefill
and decode do. ``forward`` and ``loss_fn`` are the training side: the
prefill's runners without a cache, summing the balance loss, on the
plain attention path that autograd differentiates.

The VLM and audio prefills take a ``frontend`` (B, M, d): patch or frame
embeddings. Products take the promoted type of their operands
(``common.mm``), as JAX's do: over bf16 weights an fp32 frontend (the
engine's) gives an fp32 encoder, memory and cross K/V, and a decoder
hidden state in bf16. LoRA reaches what the JAX package's reaches and no
more (ROADMAP C3): the audio decoder's self-attention in prefill only,
nothing of the VLM; the bank is passed and ignored elsewhere.

The hybrid's LoRA bank holds one layer, the shared block's, and the same
callback serves every application of it. RWKV-6 takes its adapters on
the receptance (the ``q`` target), key, value and output projections.

``tp`` (a ``launch.mesh.TensorParallel``, optional) runs a rank of a
tensor-parallel model, of every family: ``params`` is the rank's slice
(``serving.sharding.EngineSharding.shard_params``, or ``init_params(tp=
...)`` directly), the cache holds its heads (kv heads, regrouped where
tp does not divide them; cross K/V heads; Mamba2 and WKV heads; MLA's
latent and the RWKV-6 token shifts whole), and the LoRA bank its
co-sharded slice. The norms are replicated; where tp divides V the
embedding holds the rank's V/tp rows and ``lm_head`` its V/tp columns
(vocab-parallel, the JAX package's ``_EMBED`` and ``_COL`` rules), and
replicated otherwise. A rank looks its tokens up in its rows, writes
zeros for the others and one all-reduce sums them, which is exact (one
addend is nonzero); its logits are the (B, V/tp) fp32 slice, all-gathered
along V, each logit the same dot product as at tp = 1. The hidden state
after every all-reduce (or all-gather) is the same on every rank, so
every rank computes the same logits. The MoE layers take the
expert-parallel path at prefill where it applies (``ffn.ep_applicable``;
at dp > 1 each dp replica routes its share of the group, as the JAX
mesh's "data" shards do) and the drop-free path elsewhere.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.lora.batched import make_lora_cb

from .attention import (CrossAttention, GQAAttention, MLAAttention,
                        cross_attend, cross_kv, gqa_decode, gqa_full,
                        local_kv_heads, mla_decode, mla_full)
from .common import (all_gather_, all_reduce_, chunked_cross_entropy,
                     dense_init, rmsnorm, tp_size)
from .ffn import MoE, SwiGLU, moe_ffn
from .ssm import (Mamba2, RWKV6, mamba2_full, mamba2_state, mamba2_step,
                  mamba_dims, rwkv6_channel_mix, rwkv6_state,
                  rwkv6_time_mix)

# family -> the state-space kind it needs (None: no ``cfg.ssm``)
_FAMILIES = {"dense": None, "moe": None, "hybrid": "mamba2", "ssm": "rwkv6",
             "vlm": None, "audio": None}


def _check_family(cfg) -> None:
    kind = cfg.ssm.kind if cfg.ssm is not None else None
    if cfg.family not in _FAMILIES or kind != _FAMILIES[cfg.family]:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (ssm {kind!r}) is not one "
            "of the JAX package's: " + ", ".join(
                f + (f" ({k})" if k else "") for f, k in _FAMILIES.items()))


def _cache_keys(cfg):
    """The two per-layer cache entries of an attention layer."""
    return ("c", "kr") if cfg.mla is not None else ("k", "v")


def n_attn_applications(cfg) -> int:
    """Number of self-attention cache entries (the k/v leading dim)."""
    if cfg.family == "hybrid":
        return -(-cfg.n_layers // cfg.attn_every)
    if cfg.family == "ssm":
        return 0
    if cfg.family == "vlm":
        return cfg.n_layers - cfg.n_layers // cfg.cross_attn_every
    return cfg.n_layers


def n_cross_applications(cfg) -> int:
    """Number of cross-attention cache entries (the xk/xv leading dim)."""
    if cfg.family == "vlm":
        return cfg.n_layers // cfg.cross_attn_every
    if cfg.family == "audio":
        return cfg.n_layers
    return 0


def _hybrid_segments(cfg):
    """[(start, n_mamba_layers)], one per shared-attention application."""
    return [(start, min(cfg.attn_every, cfg.n_layers - start))
            for start in range(0, cfg.n_layers, cfg.attn_every)]


def _const(value, n, gen, dtype):
    return nn.Parameter(torch.full((n,), value, dtype=dtype,
                                   device=gen.device), requires_grad=False)


class DenseBlock(nn.Module):
    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _const(1.0, d, gen, dtype)
        self.ln2 = _const(1.0, d, gen, dtype)
        self.attn = (MLAAttention if cfg.mla is not None else GQAAttention)(
            cfg, gen, dtype)
        self.ffn = MoE(cfg, gen, dtype) if cfg.moe is not None else \
            SwiGLU(d, cfg.d_ff, gen, dtype)


class CrossBlock(nn.Module):
    """The VLM's gated cross-attention block (the JAX
    ``_init_cross_block``): ln1, ln2, attn (``CrossAttention``), ffn
    (``SwiGLU``), gate_attn and gate_ffn of shape (1,), 0 at init."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _const(1.0, d, gen, dtype)
        self.ln2 = _const(1.0, d, gen, dtype)
        self.attn = CrossAttention(cfg, gen, dtype)
        self.ffn = SwiGLU(d, cfg.d_ff, gen, dtype)
        self.gate_attn = _const(0.0, 1, gen, dtype)
        self.gate_ffn = _const(0.0, 1, gen, dtype)


class EncDecBlock(nn.Module):
    """The encoder-decoder's decoder block (the JAX
    ``_init_encdec_dec_block``): ln1, lnc, ln2, attn (``GQAAttention``),
    cross (``CrossAttention``), ffn (``SwiGLU``)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        d = cfg.d_model
        self.ln1 = _const(1.0, d, gen, dtype)
        self.lnc = _const(1.0, d, gen, dtype)
        self.ln2 = _const(1.0, d, gen, dtype)
        self.attn = GQAAttention(cfg, gen, dtype)
        self.cross = CrossAttention(cfg, gen, dtype)
        self.ffn = SwiGLU(d, cfg.d_ff, gen, dtype)


def _whole(block: nn.Module) -> nn.Module:
    return block


class BaseLM(nn.Module):
    """embed: (V, d); ln_f: (d,); lm_head: (d, V) unless tied. Each
    family's blocks pass through ``shard`` as they are drawn
    (``init_params(tp=...)``: the rank's slice, one full block at a time
    in memory)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
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


class DenseLM(BaseLM):
    """The dense and MoE families: ``blocks`` of ``DenseBlock``."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
        super().__init__(cfg, gen, dtype)
        self.blocks = nn.ModuleList(shard(DenseBlock(cfg, gen, dtype))
                                    for _ in range(cfg.n_layers))


class HybridLM(BaseLM):
    """zamba2: ``mamba_blocks`` (one ``Mamba2`` a layer) and one
    ``shared_attn`` ``DenseBlock``."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
        super().__init__(cfg, gen, dtype)
        self.mamba_blocks = nn.ModuleList(shard(Mamba2(cfg, gen, dtype))
                                          for _ in range(cfg.n_layers))
        self.shared_attn = shard(DenseBlock(cfg, gen, dtype))


class RWKVLM(BaseLM):
    """RWKV-6: ``blocks`` of ``RWKV6``."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
        super().__init__(cfg, gen, dtype)
        self.blocks = nn.ModuleList(shard(RWKV6(cfg, gen, dtype))
                                    for _ in range(cfg.n_layers))


class VisionLM(BaseLM):
    """The VLM: ``self_blocks`` (``DenseBlock``, n_layers - n_cross of
    them) and ``cross_blocks`` (``CrossBlock``, n_cross = n_layers //
    cross_attn_every)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
        super().__init__(cfg, gen, dtype)
        self.self_blocks = nn.ModuleList(
            shard(DenseBlock(cfg, gen, dtype))
            for _ in range(n_attn_applications(cfg)))
        self.cross_blocks = nn.ModuleList(
            shard(CrossBlock(cfg, gen, dtype))
            for _ in range(n_cross_applications(cfg)))


class EncDecLM(BaseLM):
    """The audio encoder-decoder: ``enc_blocks`` (``DenseBlock``,
    ``cfg.encoder.n_layers``), ``enc_ln_f`` and ``dec_blocks``
    (``EncDecBlock``, ``cfg.n_layers``)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32,
                 shard=_whole):
        super().__init__(cfg, gen, dtype)
        self.enc_blocks = nn.ModuleList(shard(DenseBlock(cfg, gen, dtype))
                                        for _ in range(cfg.encoder.n_layers))
        self.enc_ln_f = _const(1.0, cfg.d_model, gen, dtype)
        self.dec_blocks = nn.ModuleList(shard(EncDecBlock(cfg, gen, dtype))
                                        for _ in range(cfg.n_layers))


_LM_CLASS = {"dense": DenseLM, "moe": DenseLM, "hybrid": HybridLM,
             "ssm": RWKVLM, "vlm": VisionLM, "audio": EncDecLM}


def init_params(cfg, seed: int = 0, *, dtype=torch.float32,
                device="cuda", tp=None) -> BaseLM:
    """Random base weights from one ``torch.Generator`` on ``device``
    (not the JAX package's numbers: tests carry weights across with
    ``repro_torch.bridge``): a ``DenseLM``, ``HybridLM``, ``RWKVLM``,
    ``VisionLM`` or ``EncDecLM`` by ``cfg.family``. With ``tp`` (size >
    1), this rank's slice of the same weights, each block sliced as soon
    as it is drawn, so the full model is never held; the engine takes
    it as it is (``tp_shard`` names the slice); the embedding and the
    head are drawn whole and cut to the rank's rows and columns once the
    model is drawn."""
    _check_family(cfg)
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(seed)
    if tp_size(tp) == 1:
        return _LM_CLASS[cfg.family](cfg, gen, dtype)
    from repro_torch.serving.sharding import EngineSharding
    sh = EngineSharding(tp, cfg)
    lm = _LM_CLASS[cfg.family](cfg, gen, dtype, sh.shard_module)
    for name in ("embed", "lm_head"):
        p, axis = getattr(lm, name, None), sh.axis(name)
        if p is not None and axis is not None:
            setattr(lm, name, nn.Parameter(sh.split(p.detach(), axis, name),
                                           requires_grad=False))
    lm.tp_shard = (tp.rank, tp.size)
    return lm


def lm_head(cfg, params: BaseLM):
    """(d, V), or the rank's (d, V/tp) columns where the vocabulary is
    split."""
    return params.embed.T if cfg.tie_embeddings else params.lm_head


def _vocab_split(cfg, params: BaseLM, tp) -> bool:
    return tp_size(tp) > 1 and params.embed.shape[0] < cfg.vocab_size


def _logits(cfg, params: BaseLM, h, tp):
    """fp32 logits (B, V) of the last hidden state h (B, d): the rank's
    (B, V/tp) slice all-gathered along V where the vocabulary is split."""
    lg = h.float() @ lm_head(cfg, params).float()
    return all_gather_(lg, tp) if _vocab_split(cfg, params, tp) else lg


def bank_layer(bank, i: int):
    """Layer ``i`` of a padded bank dict or of each bucket's dict (views)."""
    if bank is None:
        return None
    if isinstance(bank, (tuple, list)):
        return tuple(bank_layer(b, i) for b in bank)
    return {t: {"A": w["A"][i], "B": w["B"][i]} for t, w in bank.items()}


def _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp):
    """The LoRA hook of bank layer ``i``; MLA's ``k`` delta gathered to
    full width at tp > 1 (it adds to the replicated latent)."""
    return make_lora_cb(bank_layer(bank, i), lora_idx, kernel=lora_kernel,
                        tp=tp, gathered=("k",) if cfg.mla else ())


def _ffn(cfg, bp: DenseBlock, x, tp):
    """The block's FFN on rmsnorm(x): (out, the MoE's balance loss, or
    0.0 for a SwiGLU)."""
    xn = rmsnorm(x, bp.ln2, cfg.rmsnorm_eps)
    if cfg.moe is not None:
        return moe_ffn(cfg, bp.ffn, xn, tp=tp)
    return bp.ffn(xn, tp), 0.0


def _dense_block_full(cfg, bp: DenseBlock, x, window, lora, tp,
                      flash_kernel=True):
    """Returns (x, (k, v) or MLA's (c, kr), the FFN's balance loss)."""
    # positions None: the prefill's arange(S), which lets MHA attention
    # take kernel B5 (unless flash_kernel is False)
    attn = mla_full if cfg.mla is not None else gqa_full
    h, kv = attn(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                 window=window, lora=lora, tp=tp, flash_kernel=flash_kernel)
    x = x + h
    f, aux = _ffn(cfg, bp, x, tp)
    return x + f, kv, aux


def _dense_block_decode(cfg, bp: DenseBlock, x, kc, vc, pos, window, lora,
                        tp, mla_absorbed=False):
    xn = rmsnorm(x, bp.ln1, cfg.rmsnorm_eps)
    if cfg.mla is not None:
        h, _ = mla_decode(cfg, bp.attn, xn, kc, vc, pos, window=window,
                          lora=lora, absorbed=mla_absorbed, tp=tp)
    else:
        h, _ = gqa_decode(cfg, bp.attn, xn, kc, vc, pos, window=window,
                          lora=lora, tp=tp)
    x = x + h
    return x + _ffn(cfg, bp, x, tp)[0]


def _cross_block(cfg, bp: CrossBlock, x, kc, vc, tp, flash_kernel=True):
    """The VLM's gated block: x + tanh(gate_attn) * cross-attention, then
    + tanh(gate_ffn) * SwiGLU."""
    h = cross_attend(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps), kc,
                     vc, tp=tp, flash_kernel=flash_kernel)
    x = x + torch.tanh(bp.gate_attn) * h
    return x + torch.tanh(bp.gate_ffn) * _ffn(cfg, bp, x, tp)[0]


def _rwkv_block(cfg, bp: RWKV6, x, st, lora, tp):
    h, st_tm = rwkv6_time_mix(cfg, bp, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                              st, lora, tp)
    x = x + h
    h2, st_cm = rwkv6_channel_mix(cfg, bp,
                                  rmsnorm(x, bp.ln2, cfg.rmsnorm_eps), st,
                                  tp)
    return x + h2, {**st_tm, **st_cm}


def _mamba_layer(cfg, bp: Mamba2, x, state, step: bool, tp):
    """x + the Mamba2 block on rmsnorm(x); returns (x, new state)."""
    fn = mamba2_step if step else mamba2_full
    out, st = fn(cfg, bp, rmsnorm(x, bp.ln, cfg.rmsnorm_eps), state, tp)
    return x + out, st


def _embed(cfg, params: BaseLM, tokens, tp=None):
    """The tokens' embedding rows. Where the vocabulary is split, the rank
    looks up the tokens in its rows, writes zeros for the others, and one
    all-reduce sums the ranks' (exact: one addend is nonzero)."""
    if not _vocab_split(cfg, params, tp):
        return params.embed[tokens.long()]
    n = params.embed.shape[0]
    local = tokens.long() - tp.rank * n
    mine = (local >= 0) & (local < n)
    x = params.embed[local.clamp(0, n - 1)]
    return all_reduce_(torch.where(mine[..., None], x, torch.zeros_like(x)),
                       tp)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.float32,
               device="cuda", tp=None, enc_len: Optional[int] = None):
    """Zeroed cache dict. max_len should already account for any sliding
    window (callers pass min(seq, window)). At tp > 1 it holds this rank's
    heads, and no full cache is ever made: its kv heads, self- and
    cross-attention alike (n_kv_heads / tp, the JAX package's
    kv-head-sharded "baseline" layout, or the regroup's
    ``local_kv_heads``), its Mamba2 and WKV heads; MLA's latent ``c``/
    ``kr`` and the RWKV-6 token shifts are whole on every rank. The WKV
    state is fp32 whatever ``dtype``, as in the JAX package. The cross
    K/V hold ``enc_len`` positions (by default the config's frames or
    frontend tokens)."""
    _check_family(cfg)
    dev = resolve_device(device)
    n = tp_size(tp)
    cache = {"pos": torch.zeros(batch, dtype=torch.int32, device=dev)}
    n_attn = n_attn_applications(cfg)
    lead = (n_attn, batch, max_len)
    shapes = {}
    if cfg.mla is not None:
        m = cfg.mla
        shapes = {"c": lead + (m.kv_lora_rank,),
                  "kr": lead + (m.qk_rope_head_dim,)}
    elif n_attn:
        kv = lead + (local_kv_heads(cfg, n), cfg.resolved_head_dim)
        shapes = {"k": kv, "v": kv}
    n_cross = n_cross_applications(cfg)
    if n_cross:
        M = enc_len or (cfg.encoder.n_frames if cfg.encoder
                        else cfg.n_frontend_tokens)
        shapes["xk"] = shapes["xv"] = (n_cross, batch, M,
                                       local_kv_heads(cfg, n),
                                       cfg.resolved_head_dim)
    if cfg.family == "hybrid":
        _, H, hd, N = mamba_dims(cfg)
        shapes["ssm"] = (cfg.n_layers, batch, H // n, hd, N)
    for name, shape in shapes.items():
        cache[name] = torch.zeros(shape, dtype=dtype, device=dev)
    if cfg.family == "ssm":
        for name, t in rwkv6_state(cfg, batch, dtype, dev, tp).items():
            cache[name] = t.new_zeros((cfg.n_layers,) + t.shape)
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


def _write_kv(cfg, cache, i, kv, window):
    """Layer (or application) ``i``'s prefill K/V into the cache, one at a
    time (no stacked (L, ...) copy); nothing without a cache (``forward``
    runs the runners with ``cache=None``)."""
    if cache is None:
        return
    for name, t in zip(_cache_keys(cfg), kv):
        _write_prefill_kv(t[None], cache[name][i:i + 1], window)


def _remat(remat, fn, *args):
    """fn(*args); with ``remat``, checkpointed (the JAX ``jax.checkpoint``
    of a layer): its activations are made again in the backward pass,
    the same values, instead of kept."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _run_dense_full(cfg, params: DenseLM, x, cache, *, window, bank,
                    lora_idx, lora_kernel, tp, remat=False,
                    flash_kernel=True):
    aux = 0.0
    for i, bp in enumerate(params.blocks):
        lora = _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp)
        x, kv, a = _remat(remat, functools.partial(
            _dense_block_full, cfg, bp, window=window, lora=lora, tp=tp,
            flash_kernel=flash_kernel), x)
        aux = aux + a
        _write_kv(cfg, cache, i, kv, window)
    return x, aux


def _write_cross(cache, i, xk, xv):
    """Cross-attention application ``i``'s K/V into the cache, in its
    type; nothing without a cache."""
    if cache is None:
        return
    cache["xk"][i] = xk.to(cache["xk"].dtype)
    cache["xv"][i] = xv.to(cache["xv"].dtype)


def _run_vlm_full(cfg, params: VisionLM, x, cache, *, window, frontend,
                  bank, lora_idx, lora_kernel, tp, remat=False,
                  flash_kernel=True):
    # no adapter reaches the VLM (the JAX ``_run_vlm_full`` binds none)
    per = cfg.cross_attn_every - 1
    aux = 0.0
    for p, cb in enumerate(params.cross_blocks):
        xk, xv = cross_kv(cfg, cb.attn, frontend)
        for i in range(p * per, (p + 1) * per):
            x, kv, a = _remat(remat, functools.partial(
                _dense_block_full, cfg, params.self_blocks[i],
                window=window, lora=None, tp=tp,
                flash_kernel=flash_kernel), x)
            aux = aux + a
            _write_kv(cfg, cache, i, kv, window)
        x = _cross_block(cfg, cb, x, xk, xv, tp, flash_kernel)
        _write_cross(cache, p, xk, xv)
    return x, aux


def _run_audio_encoder(cfg, params: EncDecLM, frames, tp=None,
                       flash_kernel=True):
    """The bidirectional encoder over frame embeddings (B, M, d): RoPE over
    the frame positions, non-causal self-attention (B5 for MHA unless
    ``flash_kernel`` is False), SwiGLU; the memory after ``enc_ln_f``, in
    the promoted type of the frames and the weights. At tp > 1 a dense
    stack split as the decoder's is; the memory is whole on every
    rank."""
    x = frames
    for bp in params.enc_blocks:
        h, _ = gqa_full(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                        causal=False, tp=tp, flash_kernel=flash_kernel)
        x = x + h
        x = x + _ffn(cfg, bp, x, tp)[0]
    return rmsnorm(x, params.enc_ln_f, cfg.rmsnorm_eps)


def _audio_dec_block(cfg, bp: EncDecBlock, x, xk, xv, *, window, lora, tp,
                     flash_kernel):
    """One decoder layer: (x, its self-attention's (k, v))."""
    h, kv = gqa_full(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                     window=window, lora=lora, tp=tp,
                     flash_kernel=flash_kernel)
    x = x + h
    x = x + cross_attend(cfg, bp.cross, rmsnorm(x, bp.lnc, cfg.rmsnorm_eps),
                         xk, xv, tp=tp, flash_kernel=flash_kernel)
    return x + _ffn(cfg, bp, x, tp)[0], kv


def _run_audio_full(cfg, params: EncDecLM, x, cache, *, window, frontend,
                    bank, lora_idx, lora_kernel, tp, remat=False,
                    flash_kernel=True):
    memory = _run_audio_encoder(cfg, params, frontend, tp, flash_kernel)
    for i, bp in enumerate(params.dec_blocks):
        xk, xv = cross_kv(cfg, bp.cross, memory)
        # the decoder's self-attention is the only LoRA site (ROADMAP C3)
        lora = _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp)
        x, kv = _remat(remat, functools.partial(
            _audio_dec_block, cfg, bp, window=window, lora=lora, tp=tp,
            flash_kernel=flash_kernel), x, xk, xv)
        _write_kv(cfg, cache, i, kv, window)
        _write_cross(cache, i, xk, xv)
    # the reference's decoder adds no balance loss
    return x, 0.0


def _run_hybrid_full(cfg, params: HybridLM, x, cache, *, window, bank,
                     lora_idx, lora_kernel, tp, remat=False,
                     flash_kernel=True):
    # one bank layer: the shared block's adapters at every application
    lora = _layer_lora(cfg, bank, 0, lora_idx, lora_kernel, tp)
    aux = 0.0
    for i, (start, size) in enumerate(_hybrid_segments(cfg)):
        x, kv, a = _dense_block_full(cfg, params.shared_attn, x, window,
                                     lora, tp, flash_kernel)
        aux = aux + a
        _write_kv(cfg, cache, i, kv, window)
        for j in range(start, start + size):
            x, st = _remat(remat, functools.partial(
                _mamba_layer, cfg, params.mamba_blocks[j], step=False,
                tp=tp), x,
                mamba2_state(cfg, x.shape[0], device=x.device, tp=tp))
            if cache is not None:
                cache["ssm"][j] = st
    return x, aux


def _run_rwkv_full(cfg, params: RWKVLM, x, cache, *, window, bank,
                   lora_idx, lora_kernel, tp, remat=False,
                   flash_kernel=True):
    st0 = rwkv6_state(cfg, x.shape[0], x.dtype, x.device, tp)
    for i, bp in enumerate(params.blocks):
        lora = _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp)
        x, st = _remat(remat, functools.partial(
            _rwkv_block, cfg, bp, st=st0, lora=lora, tp=tp), x)
        if cache is not None:
            for name, t in st.items():
                cache[name][i] = t
    return x, 0.0


_RUN_FULL = {"dense": _run_dense_full, "moe": _run_dense_full,
             "hybrid": _run_hybrid_full, "ssm": _run_rwkv_full,
             "vlm": _run_vlm_full, "audio": _run_audio_full}


def _cross_args(cfg, frontend, what):
    """The runner's ``frontend`` keyword: the VLM and audio families need
    one (B, M, d), the others take no part of it."""
    if not n_cross_applications(cfg):
        return {}
    if frontend is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} {what} needs a "
                         "frontend (B, M, d)")
    return {"frontend": frontend}


def forward(cfg, params: BaseLM, tokens, *, frontend=None, bank=None,
            lora_idx=None, window: Optional[int] = None, remat=False,
            lora_kernel="einsum"):
    """Teacher-forced full-sequence forward, the JAX ``forward``: returns
    (h (B, S, d) after ``ln_f``, aux), aux the fp32 sum of the MoE layers'
    balance losses (0 for the other families). The prefill's runners with
    no cache, every attention on the plain ``common.flash_attention``
    (``flash_kernel=False``: B5 has no backward) and LoRA through
    ``lora_kernel``, whose default "einsum" autograd differentiates (the
    SGMV kernels refuse inputs that require grad). ``remat``
    checkpoints a layer where the JAX forward applies
    ``jax.checkpoint``: every dense, MoE and RWKV-6 layer, the VLM's
    self-attention layers, the audio decoder's layers and the hybrid's
    Mamba2 layers; loss and gradients are the same bits either way."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    x = _embed(cfg, params, tokens)
    h, aux = _RUN_FULL[cfg.family](
        cfg, params, x, None, window=window, bank=bank, lora_idx=lora_idx,
        lora_kernel=lora_kernel, tp=None, remat=remat, flash_kernel=False,
        **_cross_args(cfg, frontend, "forward"))
    return (rmsnorm(h, params.ln_f, cfg.rmsnorm_eps),
            torch.as_tensor(aux, dtype=torch.float32, device=h.device))


def loss_fn(cfg, params: BaseLM, batch, *, remat=True, aux_coef=0.01):
    """The JAX ``loss_fn``: ``chunked_cross_entropy`` of ``forward`` on
    batch["tokens"] (and batch["frontend"], where the family takes one)
    against batch["labels"], plus aux_coef times the balance loss."""
    h, aux = forward(cfg, params, batch["tokens"],
                     frontend=batch.get("frontend"), remat=remat)
    loss = chunked_cross_entropy(h, lm_head(cfg, params), batch["labels"])
    return loss + aux_coef * aux


def prefill(cfg, params: BaseLM, tokens, *, frontend=None, bank=None,
            lora_idx=None, cache_len: Optional[int] = None,
            window: Optional[int] = None, cache_dtype=None,
            lora_kernel="einsum", tp=None):
    """Prefill a batch of same-length rows. ``frontend`` (B, M, d): the
    VLM's patch or the audio encoder's frame embeddings, which those
    families need and the others take no part of. Returns (last_logits
    (B,V), cache)."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    B, S = tokens.shape
    cache_len = cache_len or (min(S, window) if window else S)
    x = _embed(cfg, params, tokens, tp)
    cross = _cross_args(cfg, frontend, "prefill")
    cache = init_cache(cfg, B, cache_len, cache_dtype or params.embed.dtype,
                       device=tokens.device, tp=tp,
                       enc_len=frontend.shape[1] if cross else None)
    x, _ = _RUN_FULL[cfg.family](cfg, params, x, cache, window=window,
                                 bank=bank, lora_idx=lora_idx,
                                 lora_kernel=lora_kernel, tp=tp, **cross)
    cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                              device=tokens.device)
    h_last = rmsnorm(x[:, -1], params.ln_f, cfg.rmsnorm_eps)
    return _logits(cfg, params, h_last, tp), cache


def _decode_dense(cfg, params: DenseLM, cache, x, pos, *, window, bank,
                  lora_idx, lora_kernel, tp, mla_absorbed):
    ka, kb = _cache_keys(cfg)
    for i, bp in enumerate(params.blocks):
        lora = _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp)
        x = _dense_block_decode(cfg, bp, x, cache[ka][i], cache[kb][i],
                                pos, window, lora, tp, mla_absorbed)
    return x


def _decode_hybrid(cfg, params: HybridLM, cache, x, pos, *, window, bank,
                   lora_idx, lora_kernel, tp, mla_absorbed):
    lora = _layer_lora(cfg, bank, 0, lora_idx, lora_kernel, tp)
    for i, (start, size) in enumerate(_hybrid_segments(cfg)):
        x = _dense_block_decode(cfg, params.shared_attn, x, cache["k"][i],
                                cache["v"][i], pos, window, lora, tp)
        for j in range(start, start + size):
            # the state comes back in x's type and is stored in the cache's
            x, cache["ssm"][j] = _mamba_layer(
                cfg, params.mamba_blocks[j], x, cache["ssm"][j], True, tp)
    return x


def _decode_rwkv(cfg, params: RWKVLM, cache, x, pos, *, window, bank,
                 lora_idx, lora_kernel, tp, mla_absorbed):
    for i, bp in enumerate(params.blocks):
        lora = _layer_lora(cfg, bank, i, lora_idx, lora_kernel, tp)
        # The token shifts hold activations of x's type; a cache of
        # another type gives them back in it (exactly: they were x's
        # type when stored). The JAX decode takes them in the cache's
        # type, and with bf16 weights over an fp32 cache its layer scan
        # refuses the fp32 residual that follows (ROADMAP C12).
        st = {"wkv": cache["wkv"][i],
              "x_tm": cache["x_tm"][i].to(x.dtype),
              "x_cm": cache["x_cm"][i].to(x.dtype)}
        x, st = _rwkv_block(cfg, bp, x, st, lora, tp)
        for name, t in st.items():
            cache[name][i] = t
    return x


def _decode_vlm(cfg, params: VisionLM, cache, x, pos, *, window, bank,
                lora_idx, lora_kernel, tp, mla_absorbed):
    per = cfg.cross_attn_every - 1
    for p, cb in enumerate(params.cross_blocks):
        for i in range(p * per, (p + 1) * per):
            x = _dense_block_decode(cfg, params.self_blocks[i], x,
                                    cache["k"][i], cache["v"][i], pos,
                                    window, None, tp)
        x = _cross_block(cfg, cb, x, cache["xk"][p], cache["xv"][p], tp)
    return x


def _decode_audio(cfg, params: EncDecLM, cache, x, pos, *, window, bank,
                  lora_idx, lora_kernel, tp, mla_absorbed):
    # no adapter in decode: the JAX decode binds none (ROADMAP C3)
    for i, bp in enumerate(params.dec_blocks):
        h, _ = gqa_decode(cfg, bp.attn, rmsnorm(x, bp.ln1, cfg.rmsnorm_eps),
                          cache["k"][i], cache["v"][i], pos, window=window,
                          tp=tp)
        x = x + h
        x = x + cross_attend(cfg, bp.cross,
                             rmsnorm(x, bp.lnc, cfg.rmsnorm_eps),
                             cache["xk"][i], cache["xv"][i], tp=tp)
        x = x + _ffn(cfg, bp, x, tp)[0]
    return x


_DECODE = {"dense": _decode_dense, "moe": _decode_dense,
           "hybrid": _decode_hybrid, "ssm": _decode_rwkv,
           "vlm": _decode_vlm, "audio": _decode_audio}


def decode_step(cfg, params: BaseLM, cache, tokens, *, bank=None,
                lora_idx=None, window: Optional[int] = None,
                mla_absorbed=False, lora_kernel="einsum", tp=None):
    """One decode step. tokens: (B,) int. Returns (logits (B,V), cache):
    the tensors of ``cache`` are updated in place, ``pos`` is new.
    ``mla_absorbed`` selects MLA's absorbed decode (the engine's is the
    naive expand)."""
    _check_family(cfg)
    window = cfg.sliding_window if window is None else window
    pos = cache["pos"]
    x = _embed(cfg, params, tokens[:, None], tp)
    x = _DECODE[cfg.family](cfg, params, cache, x, pos, window=window,
                            bank=bank, lora_idx=lora_idx,
                            lora_kernel=lora_kernel, tp=tp,
                            mla_absorbed=mla_absorbed)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    h_last = rmsnorm(x[:, 0], params.ln_f, cfg.rmsnorm_eps)
    return _logits(cfg, params, h_last, tp), new_cache
