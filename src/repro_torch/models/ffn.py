"""Feed-forward layers of the PyTorch port: SwiGLU and the
mixture-of-experts layer, the single-device paths of the JAX package's
``models/ffn.py`` (its expert-parallel ``moe_ffn_ep`` waits for ROADMAP
queue A item 9).

Tensor parallel (``tp``): a rank holds column slices of ``w1``/``w3``
and the matching row slice of ``w2`` (d_ff/tp of each), so its output is
a partial sum that one ``all_reduce_`` completes. The MoE layer is not
tensor-parallel (``serving.sharding`` refuses it at tp > 1)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .common import all_reduce_, dense_init, mm


def _frozen(t):
    return nn.Parameter(t, requires_grad=False)


class SwiGLU(nn.Module):
    """w1, w3: (d, ff); w2: (ff, d), used as ``x @ w``."""

    def __init__(self, d: int, ff: int, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.w1 = _frozen(dense_init(gen, (d, ff), dtype=dtype))
        self.w3 = _frozen(dense_init(gen, (d, ff), dtype=dtype))
        self.w2 = _frozen(dense_init(gen, (ff, d), fan_in=ff, dtype=dtype))

    def forward(self, x, tp=None):
        """In the promoted type of x and the weights (``common.mm``)."""
        h = F.silu(mm(x, self.w1)) * mm(x, self.w3)
        return all_reduce_(mm(h, self.w2), tp)


class MoE(nn.Module):
    """router: (d, E), fp32 whatever ``dtype`` (as the JAX ``init_moe``
    makes it); we1, we3: (E, d, f); we2: (E, f, d); with shared experts,
    their SwiGLU as ws1, ws3: (d, n_shared*f) and ws2: (n_shared*f, d)
    (the JAX ``init_swiglu(prefix="s")`` names)."""

    def __init__(self, cfg, gen: torch.Generator, dtype=torch.float32):
        super().__init__()
        e = cfg.moe
        d, E, f = cfg.d_model, e.n_experts, e.d_ff_expert
        self.router = _frozen(dense_init(gen, (d, E), dtype=torch.float32))
        self.we1 = _frozen(dense_init(gen, (E, d, f), fan_in=d, dtype=dtype))
        self.we3 = _frozen(dense_init(gen, (E, d, f), fan_in=d, dtype=dtype))
        self.we2 = _frozen(dense_init(gen, (E, f, d), fan_in=f, dtype=dtype))
        if e.n_shared_experts:
            fs = e.n_shared_experts * f
            self.ws1 = _frozen(dense_init(gen, (d, fs), dtype=dtype))
            self.ws3 = _frozen(dense_init(gen, (d, fs), dtype=dtype))
            self.ws2 = _frozen(dense_init(gen, (fs, d), fan_in=fs,
                                          dtype=dtype))


def moe_capacity(N: int, K: int, E: int, capacity_factor: float) -> int:
    """Slots an expert gets for N tokens routed top-K over E experts:
    N when N <= 8192 (drop-free: every token could pick one expert), else
    ceil(K N / E * capacity_factor)."""
    if N <= 8192:
        return N
    return max(1, math.ceil(K * N / E * capacity_factor))


def moe_topk(cfg, router, xf):
    """The router's softmax over the experts in fp32 and its top k,
    renormalised. xf: (N, d). Returns (probs (N, E), topw (N, K), topi
    (N, K))."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def moe_route(cfg, router, xf, capacity_factor: float = 1.25):
    """Top-k routing and the sort-pack layout of the JAX ``moe_ffn``.
    xf: (N, d). Returns (topw (N, K) fp32 renormalised, topi (N, K), order
    (M,) the stable argsort of the M = N K expert ids, dest (M,) each
    sorted assignment's slot in the (E C) packed rows (E C: dropped), C,
    aux). No host sync: C comes from shapes."""
    e = cfg.moe
    N = xf.shape[0]
    K, E = e.top_k, e.n_experts
    probs, topw, topi = moe_topk(cfg, router, xf)
    ones = torch.ones(N, dtype=torch.float32, device=xf.device)
    ce = torch.zeros(E, dtype=torch.float32, device=xf.device).scatter_add_(
        0, topi[:, 0], ones) / N                  # mean one-hot of the top 1
    aux = E * (probs.mean(0) * ce).sum()          # Switch-style balance loss
    eid = topi.reshape(N * K)
    order = torch.argsort(eid, stable=True)
    eid_s = eid[order]
    counts = torch.zeros(E, dtype=torch.long, device=xf.device).scatter_add_(
        0, eid, torch.ones_like(eid))
    offsets = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * K, device=xf.device) - offsets[eid_s]
    C = moe_capacity(N, K, E, capacity_factor)
    dest = torch.where(rank < C, eid_s * C + rank, E * C)
    return topw, topi, order, dest, C, aux


def moe_ffn(cfg, p: MoE, x, capacity_factor: float = 1.25):
    """Sort-based MoE, the JAX ``moe_ffn`` on one device. x: (B, S, d) ->
    (y, aux_loss). Tokens are packed by expert into (E, C, d), the three
    expert products are batched matrix products (``torch.bmm``: plain
    products, as JAX leaves its einsums to XLA), and each token's K rows
    come back as (N, K, d), weighted, cast to x's type and summed over k in
    order. No scatter-add: atomics would sum a token's K rows in an order
    that changes from run to run on the card."""
    e = cfg.moe
    B, S, d = x.shape
    N, K, E = B * S, e.top_k, e.n_experts
    xf = x.reshape(N, d)
    topw, _, order, dest, C, aux = moe_route(cfg, p.router, xf,
                                             capacity_factor)
    xg = x.new_zeros((E * C + 1, d))              # row E C: the drop slot
    xg[dest] = xf[order // K]                     # sorted assignment's token
    xg = xg[:E * C].reshape(E, C, d)
    h = F.silu(torch.bmm(xg, p.we1)) * torch.bmm(xg, p.we3)
    y = torch.bmm(h, p.we2).reshape(E * C, d)
    slot = torch.empty_like(dest)
    slot[order] = dest                            # assignment n K + k's slot
    kept = slot < E * C
    rows = y[torch.where(kept, slot, 0)] * kept[:, None]
    contrib = (topw.reshape(N * K, 1) * rows.float()).to(x.dtype)
    contrib = contrib.reshape(N, K, d)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    out = out.reshape(B, S, d)
    if e.n_shared_experts:
        out = out + (F.silu(x @ p.ws1) * (x @ p.ws3)) @ p.ws2
    return out, aux
