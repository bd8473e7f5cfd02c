"""Feed-forward layers of the PyTorch port: SwiGLU and the
mixture-of-experts layer, the JAX package's ``models/ffn.py``.

Tensor parallel (``tp``): a rank holds column slices of ``w1``/``w3``
and the matching row slice of ``w2`` (d_ff/tp of each), so its output is
a partial sum that one ``all_reduce_`` completes. The MoE layer holds
the rank's E/tp routed experts (``we1``/``we2``/``we3`` split on the
expert dim; the router whole) and its column/row slices of the shared
experts, whose partial sum ends in one ``all_reduce_``. The routed
experts take one of the reference's two paths:

* expert parallelism (``moe_ffn_ep``, the JAX ``moe_ffn_ep``) where the
  JAX ``_ep_applicable`` holds (E and S divisible by tp, S > 1: a
  prefill): each rank routes its own sequence chunk with the
  reference's capacity ``ep_capacity`` (which drops tokens), exchanges
  the packed (E, C, d) buffers with ``all_to_all_``, runs its experts,
  exchanges the outputs back and combines them, and ``all_gather_``
  puts the chunks side by side. ``moe_ffn_ep_ref`` computes the same on
  one process. At dp > 1 (``tp.dp``, which the engine passes only where
  its slot batch splits over dp) every dp replica holds the whole group,
  takes its rows [i B/dp, (i + 1) B/dp) where dp divides B (the JAX
  ``bspec``: each ("data", "model") shard sizes its capacity from its own
  B/dp S/tp tokens), runs the path on them and ``all_gather_`` over dp
  puts the rows back; where dp does not divide B every replica runs the
  whole group, as the JAX mesh's "data" shards do;
* the drop-free scatter path everywhere else (decode, S not divisible
  by tp): every rank routes every token, as at tp = 1, and computes the
  rows of its own experts; the (N, K, d) weighted rows are all-reduced.
  Each row has exactly one owner, the other ranks add zeros, so the sum
  is exact and the output equals tp = 1's on equal expert products.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.mesh import NO_DP

from .common import (all_gather_, all_reduce_, all_to_all_,
                     dense_init, mm, tp_size)


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
    (the JAX ``init_swiglu(prefix="s")`` names). At tp > 1 rank j holds
    experts j E/tp .. (j + 1) E/tp - 1 and its slices of ws1/ws3/ws2."""

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


def ep_capacity(N: int, K: int, E: int) -> int:
    """The expert-parallel path's slots per expert for a rank's N tokens:
    the JAX ``_route_pack(..., 1.5, exact_small=False)``, max(8, ceil(K N
    / E * 1.5)), which drops tokens past it however small N is."""
    return max(8, math.ceil(K * N / E * 1.5))


def moe_topk(cfg, router, xf):
    """The router's softmax over the experts in fp32 and its top k,
    renormalised. xf: (N, d). Returns (probs (N, E), topw (N, K), topi
    (N, K))."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    topw, topi = torch.topk(probs, cfg.moe.top_k, dim=-1)
    return probs, topw / topw.sum(-1, keepdim=True).clamp_min(1e-9), topi


def moe_route(cfg, router, xf, capacity_factor: float = 1.25, C=None):
    """Top-k routing and the sort-pack layout of the JAX ``moe_ffn``.
    xf: (N, d). Returns (topw (N, K) fp32 renormalised, topi (N, K), order
    (M,) the stable argsort of the M = N K expert ids, dest (M,) each
    sorted assignment's slot in the (E C) packed rows (E C: dropped), C,
    aux). No host sync: C comes from shapes (``moe_capacity`` unless
    given)."""
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
    if C is None:
        C = moe_capacity(N, K, E, capacity_factor)
    dest = torch.where(rank < C, eid_s * C + rank, E * C)
    return topw, topi, order, dest, C, aux


def _experts(p: MoE, xg):
    """The experts' SwiGLU on their packed rows, (E', C', d) -> (E', C',
    d), as batched matrix products."""
    h = F.silu(torch.bmm(xg, p.we1)) * torch.bmm(xg, p.we3)
    return torch.bmm(h, p.we2)


def _pack(xf, order, dest, K, rows: int):
    """The sorted assignments' tokens at their ``dest`` slots of ``rows``
    packed rows (a slot at or past ``rows``: the drop slot)."""
    xg = xf.new_zeros((rows + 1, xf.shape[1]))
    xg[dest.clamp(max=rows)] = xf[order // K]
    return xg[:rows]


def _rows(y, order, dest, lo: int, hi: int):
    """Each assignment's (token n, choice k at row n K + k) expert output
    from the packed outputs ``y`` of slots lo .. hi - 1, zero for an
    assignment dropped or packed outside them."""
    slot = torch.empty_like(dest)
    slot[order] = dest                            # assignment n K + k's slot
    kept = (slot >= lo) & (slot < hi)
    return y[torch.where(kept, slot - lo, 0)] * kept[:, None]


def _combine(topw, rows, shape, dtype, tp=None):
    """The weighted rows, cast to ``dtype``, all-reduced when ``tp`` is
    given (each row nonzero on one rank only), and summed over k in
    order: (N, d). No scatter-add: atomics would sum a token's K rows in
    an order that changes from run to run on the card."""
    N, K, d = shape
    contrib = (topw.reshape(N * K, 1) * rows.float()).to(dtype)
    contrib = all_reduce_(contrib, tp).reshape(N, K, d)
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def _shared(p: MoE, x, tp):
    """The shared experts' SwiGLU (the rank's slices; one all-reduce)."""
    return all_reduce_((F.silu(mm(x, p.ws1)) * mm(x, p.ws3)) @ p.ws2, tp)


def ep_applicable(cfg, S: int, tp) -> bool:
    """The JAX ``_ep_applicable``: tp > 1 divides the experts and the
    sequence, and S > 1."""
    n = tp_size(tp)
    return n > 1 and cfg.moe.n_experts % n == 0 and S % n == 0 and S > 1


def moe_ffn(cfg, p: MoE, x, capacity_factor: float = 1.25, tp=None):
    """Sort-based MoE, the JAX ``moe_ffn``. x: (B, S, d) -> (y, aux_loss).
    Tokens are packed by expert into (E, C, d), the three expert products
    are batched matrix products (``torch.bmm``: plain products, as JAX
    leaves its einsums to XLA), and each token's K rows come back as (N,
    K, d), weighted, cast to x's type and summed over k in order. At tp >
    1 the expert-parallel path where ``ep_applicable``, else the
    drop-free scatter path over the rank's experts (module docstring)."""
    e = cfg.moe
    B, S, d = x.shape
    if ep_applicable(cfg, S, tp):
        return moe_ffn_ep(cfg, p, x, tp)
    N, K, E = B * S, e.top_k, e.n_experts
    xf = x.reshape(N, d)
    topw, _, order, dest, C, aux = moe_route(cfg, p.router, xf,
                                             capacity_factor)
    El = p.we1.shape[0]                           # this rank's experts
    lo = (tp.rank if tp_size(tp) > 1 else 0) * El * C
    xg = _pack(xf, order, torch.where(dest >= lo, dest - lo, E * C), K,
               El * C)
    y = _experts(p, xg.reshape(El, C, d)).reshape(El * C, d)
    out = _combine(topw, _rows(y, order, dest, lo, lo + El * C), (N, K, d),
                   x.dtype, tp).reshape(B, S, d)
    if e.n_shared_experts:
        out = out + _shared(p, x, tp)
    return out, aux


def _ep_chunk(cfg, router, x, j: int, n: int):
    """Sequence chunk j of n, flattened row-major over (B, S/n), routed
    and packed at ``ep_capacity``: (xf, topw, order, dest, C, aux, xg (E,
    C, d))."""
    e = cfg.moe
    B, S, d = x.shape
    xf = x[:, j * S // n:(j + 1) * S // n].reshape(-1, d)
    C = ep_capacity(xf.shape[0], e.top_k, e.n_experts)
    topw, _, order, dest, C, aux = moe_route(cfg, router, xf, C=C)
    xg = _pack(xf, order, dest, e.top_k, e.n_experts * C)
    return xf, topw, order, dest, C, aux, xg.reshape(e.n_experts, C, d)


def moe_ffn_ep(cfg, p: MoE, x, tp):
    """Expert-parallel MoE on one rank (the JAX ``moe_ffn_ep``). x: (B, S,
    d), the same on every rank -> (y (B, S, d), aux of this rank's
    chunk). The rank's chunk of S/tp positions is routed and packed into
    (E, C, d); ``all_to_all_`` sends each rank its experts' rows of every
    rank's buffer, (E/tp, tp C, d) in the order of the senders; the
    outputs go back the same way, are combined into the chunk's (B S/tp,
    d) and ``all_gather_`` puts the chunks side by side."""
    dp = tp.dp
    if dp.size > 1 and x.shape[0] % dp.size == 0:
        w = x.shape[0] // dp.size
        y, aux = moe_ffn_ep(cfg, p, x[dp.rank * w:(dp.rank + 1) * w],
                            dataclasses.replace(tp, dp=NO_DP))
        return all_gather_(y, dp, dim=0), aux
    e = cfg.moe
    B, S, d = x.shape
    n, K, E = tp.size, e.top_k, e.n_experts
    El = E // n
    xf, topw, order, dest, C, aux, xg = _ep_chunk(cfg, p.router, x,
                                                  tp.rank, n)
    recv = all_to_all_(xg, tp)                    # (n El, C, d) by sender
    y = _experts(p, recv.reshape(n, El, C, d).transpose(0, 1).reshape(
        El, n * C, d))
    y = all_to_all_(y.reshape(El, n, C, d).transpose(0, 1), tp)
    out = _combine(topw, _rows(y.reshape(E * C, d), order, dest, 0, E * C),
                   (xf.shape[0], K, d), x.dtype)
    out = all_gather_(out.reshape(B, S // n, d), tp, dim=1)
    if e.n_shared_experts:
        out = out + _shared(p, x, tp)
    return out, aux


def moe_ffn_ep_ref(cfg, p: MoE, x, n: int):
    """What ``moe_ffn_ep`` computes on n ranks, on one process with every
    expert (a full ``MoE``): each of the n sequence chunks routed and
    packed on its own, every expert's rows of all chunks in one product
    in the order the ranks receive them, each chunk combined, the chunks
    side by side. The plain reference of the expert-parallel path.
    Returns (y, the mean of the chunks' aux)."""
    e = cfg.moe
    B, S, d = x.shape
    K, E = e.top_k, e.n_experts
    chunks = [_ep_chunk(cfg, p.router, x, j, n) for j in range(n)]
    C = chunks[0][4]
    y = _experts(p, torch.stack([c[6] for c in chunks], 1).reshape(
        E, n * C, d)).reshape(E, n, C, d)
    outs = []
    for j, (xf, topw, order, dest, _, _, _) in enumerate(chunks):
        rows = _rows(y[:, j].reshape(E * C, d), order, dest, 0, E * C)
        outs.append(_combine(topw, rows, (xf.shape[0], K, d),
                             x.dtype).reshape(B, S // n, d))
    out = torch.cat(outs, dim=1)
    if e.n_shared_experts:
        out = out + _shared(p, x, None)
    return out, sum(c[5] for c in chunks) / n
