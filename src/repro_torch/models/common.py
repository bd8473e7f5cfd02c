"""Shared model machinery of the PyTorch port: the token-major flattening
the SGMV path consumes, norms, rope, init, and plain-torch attention (a
chunked online-softmax ``flash_attention`` for prefill and
``attend_cache`` for decode) and the training loss
``chunked_cross_entropy``. Counterparts of the JAX package's
``models/common.py``; no library attention kernel is used.

LoRA callback contract: blocks call ``lora(name, x) -> delta`` with
x: (B, S, d_target) for a projection target name in {"q","k","v","o"};
the callback owns the adapter gather and returns the batched LoRA delta
in x.dtype (``repro_torch.lora.batched.make_lora_cb``).

Tensor parallelism: where the JAX package selects its sharded mode
through an ambient ``AxisEnv``, the port passes a ``TensorParallel``
(``repro_torch.launch.mesh``) down explicitly as ``tp``; ``None`` or a
size-1 group is the single-device model. The layers meet in three
collectives, each the identity at tp = 1: ``all_reduce_`` (a row-parallel
product's partial sums), ``all_gather_`` (column slices of a replicated
output, or sequence chunks) and ``all_to_all_`` (the expert-parallel
MoE's dispatch), and normalise a width split across the ranks with
``rmsnorm_sharded``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG_INF = -1e30


def tp_size(tp) -> int:
    return 1 if tp is None else tp.size


def all_reduce_(x, tp):
    """Sum ``x`` over the tensor-parallel group in x's type (in place when
    x is contiguous); a no-op at tp = 1. Returns the sum."""
    if tp_size(tp) > 1:
        x = x.contiguous()
        dist.all_reduce(x, group=tp.group)
    return x


def row_parallel_out(y, delta, tp):
    """A row-parallel projection's output: ``y`` is this rank's partial
    sum over its slice of the input (full d_out), ``delta`` the rank's
    column slice of an adapter's delta on it (or 0.0). The delta goes
    into its columns of the partial sum and one all-reduce sums both;
    ``y + delta`` at tp = 1."""
    if tp_size(tp) == 1:
        return y + delta
    if isinstance(delta, torch.Tensor):
        w = delta.shape[-1]
        y[..., tp.rank * w:(tp.rank + 1) * w] += delta
    return all_reduce_(y, tp)


def all_gather_(x, tp, dim: int = -1):
    """The ranks' ``x`` put side by side along ``dim`` in rank order (every
    rank's of the same shape); ``x`` itself at tp = 1."""
    if tp_size(tp) == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(tp.size)]
    dist.all_gather(parts, x, group=tp.group)
    return torch.cat(parts, dim=dim)


def all_to_all_(x, tp):
    """Split ``x`` along dim 0 into tp equal chunks, send chunk j to rank
    j, and return the chunks received, in the order of the ranks that
    sent them, along dim 0 (``all_to_all_single``); ``x`` itself at tp =
    1. gloo takes CUDA tensors for it as it does for ``all_reduce`` (it
    stages them through the host itself), so no path copies here."""
    if tp_size(tp) == 1:
        return x
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=tp.group)
    return out


def rmsnorm_sharded(x, scale, eps: float, tp):
    """``rmsnorm`` over a width split across the ranks: x holds this
    rank's slice of the normalised width and ``scale`` its slice of the
    weights. The fp32 sum of squares is all-reduced, so every rank divides
    by the root mean square of the whole width; ``rmsnorm`` at tp = 1."""
    if tp_size(tp) == 1:
        return rmsnorm(x, scale, eps)
    x32 = x.float()
    ss = all_reduce_((x32 * x32).sum(dim=-1, keepdim=True), tp)
    out = x32 * torch.rsqrt(ss / (x.shape[-1] * tp.size) + eps)
    return (out * scale.float()).to(x.dtype)


def mm(x, w):
    """x @ w in the promoted type of the two, as JAX's ``@`` computes it:
    torch refuses a product of two types, which the encoder-decoder and
    VLM families make when an fp32 frontend meets bf16 weights."""
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        return x.to(dt) @ w.to(dt)
    return x @ w


def rows_to_tokens(x):
    """(B, S, d) -> ((B*S, d), (B, S)): token t of row b sits at b*S + t,
    so per-row adapter ids repeat S times."""
    B, S, d = x.shape
    return x.reshape(B * S, d), (B, S)


def tokens_to_rows(y, B: int, S: int):
    """Inverse of ``rows_to_tokens`` for the (B*S, d_out) kernel output."""
    return y.reshape(B, S, y.shape[-1])


def rmsnorm(x, scale, eps: float = 1e-5):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Rotates
    the two halves of the head dim (not interleaved pairs); angles in
    fp32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)               # (hd/2,)
    angles = positions[..., None].float() * freqs                # (...,S,hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, fan_in=None,
               dtype=torch.float32):
    """N(0, 1/fan_in) weights drawn from ``gen`` on its device."""
    fan_in = fan_in if fan_in is not None else shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w / math.sqrt(fan_in)).to(dtype)


def flash_attention(q, k, v, *, causal: bool, q_positions, k_positions,
                    window: int = 0, chunk_q: int = 512, chunk_k: int = 1024,
                    scale: Optional[float] = None, extra_qk=None):
    """q: (B,Sq,H,hd); k,v: (B,Sk,Kv,hd). GQA via head grouping.

    Masking: causal (q_pos >= k_pos) and optional sliding window
    (q_pos - k_pos < window). Positions are int tensors (Sq,), (Sk,).
    Chunked online softmax over kv chunks, scores in fp32. Returns
    (B,Sq,H,hd) in q.dtype.

    extra_qk: optional (q2 (B,Sq,H,hd2), k2 (B,Sk,hd2)) pair whose product
    is added to the scores: MLA's shared rope key, scored as a second
    einsum (k2 has no head dim), never broadcast into a per-head K.
    """
    B, Sq, H, hd = q.shape
    _, Sk, Kv, _ = k.shape
    hdv = v.shape[-1]
    G = H // Kv
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)

    cq = min(chunk_q, Sq)
    ck = min(chunk_k, Sk)
    pad_q = (-Sq) % cq
    pad_k = (-Sk) % ck
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    kp = F.pad(k, (0, 0, 0, 0, 0, pad_k))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    if extra_qk is not None:
        q2, k2 = extra_qk
        hd2 = q2.shape[-1]
        q2p = F.pad(q2, (0, 0, 0, 0, 0, pad_q))
        k2p = F.pad(k2, (0, 0, 0, pad_k))
    qpos = F.pad(q_positions.to(torch.int32), (0, pad_q), value=-1)
    kpos = F.pad(k_positions.to(torch.int32), (0, pad_k), value=2 ** 30)
    nq, nk = qp.shape[1] // cq, kp.shape[1] // ck

    qp = qp.reshape(B, nq, cq, Kv, G, hd).float() * scale
    kp = kp.reshape(B, nk, ck, Kv, hd).float()
    vp = vp.reshape(B, nk, ck, Kv, hdv).float()
    if extra_qk is not None:
        q2p = q2p.reshape(B, nq, cq, Kv, G, hd2).float() * scale
        k2p = k2p.reshape(B, nk, ck, hd2).float()
    qpos = qpos.reshape(nq, cq)
    kpos = kpos.reshape(nk, ck)

    m = torch.full((B, nq, cq, Kv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, nq, cq, Kv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, nq, cq, Kv, G, hdv), dtype=torch.float32,
                      device=q.device)
    for j in range(nk):                     # the kv-chunk scan
        kc, vc, kposc = kp[:, j], vp[:, j], kpos[j]
        s = torch.einsum("bqckgh,bzkh->bqckgz", qp, kc)
        if extra_qk is not None:
            s = s + torch.einsum("bqckgh,bzh->bqckgz", q2p, k2p[:, j])
        mask = torch.ones((nq, cq, ck), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, :, None] >= kposc[None, None, :]
        if window:
            mask &= (qpos[:, :, None] - kposc[None, None, :]) < window
        mask &= kposc[None, None, :] < 2 ** 30
        s = torch.where(mask[None, :, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bqckgz,bzkh->bqckgh", p, vc)
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.reshape(B, nq * cq, H, hdv)[:, :Sq]
    return out.to(q.dtype)


def attend_cache(q, k_cache, v_cache, valid_mask, scale=None):
    """Single-token decode attention against a KV cache.

    q: (B,1,H,hd); caches: (B,S,Kv,hd); valid_mask: (B,S) bool. The scaled
    q is cast to the cache dtype; the products sum in fp32.
    """
    B, _, H, hd = q.shape
    Kv = k_cache.shape[2]
    hdv = v_cache.shape[-1]
    G = H // Kv
    scale = scale if scale is not None else 1.0 / (hd ** 0.5)
    qf = (q.reshape(B, Kv, G, hd) * scale).to(k_cache.dtype)
    s = torch.einsum("bkgh,bskh->bkgs", qf.float(), k_cache.float())
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, 1, H, hdv).to(q.dtype)


def _ce_chunk(hc, w, lc):
    """The summed NLL of one chunk: fp32 logits (B, c, V), logsumexp minus
    the label's logit, rows labelled -1 masked out."""
    logits = hc.float() @ w
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
    return ((lse - tgt) * (lc >= 0).float()).sum()


def chunked_cross_entropy(h, lm_head, labels, chunk: int = 256):
    """h: (B,S,d); lm_head: (d,V); labels: (B,S) int (-1: ignored). Mean
    NLL over B·S, the JAX ``chunked_cross_entropy``: S padded to a
    multiple of c = min(chunk, S) with -1 labels, fp32 logits one chunk
    at a time, the chunks' sums added in order. It never holds (B, S, V)
    logits at once: under autograd each chunk is checkpointed, so its
    logits are made again in the backward pass instead of kept."""
    B, S, _ = h.shape
    c = min(chunk, S)
    pad = (-S) % c
    hp = F.pad(h, (0, 0, 0, pad))
    lp = F.pad(labels, (0, pad), value=-1)
    w = lm_head.float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S + pad, c):
        args = (hp[:, i:i + c], w, lp[:, i:i + c])
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_ce_chunk, *args, use_reentrant=False)
        else:
            tot = tot + _ce_chunk(*args)
    return tot / (B * S)
