"""Batched heterogeneous-adapter application, the counterpart of the JAX
package's ``lora/batched.py``.

Two execution paths, each with a padded and a bucketed form:
  * gather-einsum — padded: per-row adapter index gathers its A/B from
    the bank, everything padded to the bank's max rank; bucketed: one
    masked pass per rank bucket at the bucket's own rank;
  * SGMV kernels (``repro_torch.kernels.ops``) — ``make_lora_cb(...,
    kernel="sgmv")`` flattens the (B, S, d) activation to token-major rows
    and launches one fused kernel per target: ``sgmv_fused`` (kernel B1)
    for padded banks, ``sgmv_bucketed_fused`` (kernel B2, every bucket at
    its own rank) for bucketed banks.

``apply_bank_sgmv`` is the token-major entry for a ``LoRABank``: the
fused kernels by default, or with ``fused=False`` the unfused pair B3a/B3b
(``ops.sgmv``; ``ops.sgmv_rank_bucketed`` for bucketed banks), bit for
bit the same delta.

``make_lora_cb`` is layout-polymorphic: a dict bank slice selects the
padded path with ``idx: (Bt,)`` global adapter rows; a tuple of per-
bucket slices selects the bucketed path with ``idx: (Bt, 2)`` carrying
(bucket, local-row) per request — the shape ``LoRABank.lora_idx``
produces.

Tensor parallel (``tp`` > 1, the JAX package's "coshard" mode): the bank
is co-sharded (``serving.sharding``): each A holds this rank's slice of
d_in, each B its slice of d_out. Every form runs its shrink on the
rank's d slice of x, sums the rank-r intermediate h over the ranks with
one ``all_reduce_`` in x's type (the JAX ``psum`` of the shrink's
output), and expands on the rank's d_out columns: the einsum forms in
torch, the padded kernel form on B3a/B3b, the bucketed one on B4a/B4b.
The delta comes out column-sharded like the projection it is added to;
a target whose projection is replicated (MLA's ``k`` on ``w_dkv``, named
in ``make_lora_cb(gathered=...)``) has its B split evenly all the same,
and its delta is all-gathered to full width.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import (bucketed_layout, live_rows,
                                     segment_layout, sgmv,
                                     sgmv_bucketed_fused, sgmv_fused,
                                     sgmv_rank_bucketed)
from repro_torch.kernels.sgmv import (sgmv_expand, sgmv_multibank_expand,
                                      sgmv_multibank_shrink, sgmv_shrink)
from repro_torch.models.common import (all_gather_, all_reduce_,
                                       rows_to_tokens, tokens_to_rows,
                                       tp_size)
from repro_torch.obs import host as obs_host


def _local_x(x, A, tp):
    """This rank's d slice of x, for A's d_in slice: the q, k and v
    targets get the full-width hidden state, the o target already holds
    the rank's heads."""
    d = A.shape[-2]
    if tp_size(tp) == 1 or x.shape[-1] == d:
        return x
    return x[..., tp.rank * d:(tp.rank + 1) * d]


def lora_delta(x, A, B, idx, scaling: float = 1.0, tp=None):
    """x: (Bt, S, d); A: (Na, d, r); B: (Na, r, out); idx: (Bt,) int.

    Every row pays max-rank (r = bank rank) cost regardless of its
    adapter's true rank (BGMV semantics)."""
    idx = idx.long()
    h = torch.einsum("bsd,bdr->bsr", _local_x(x, A, tp), A[idx].to(x.dtype))
    h = all_reduce_(h, tp)
    out = torch.einsum("bsr,bro->bso", h, B[idx].to(x.dtype))
    return out * scaling


def lora_delta_bucketed(x, bucket_targets, idx, scaling: float = 1.0,
                        tp=None):
    """x: (Bt, S, d); bucket_targets: per-bucket {"A","B"} slices (bucket
    b at rank r_b); idx: (Bt, 2) int of (bucket, local).

    Each bucket runs a gather-einsum at its own rank over the full row set
    with out-of-bucket rows masked to zero."""
    bucket, local = idx[..., 0], idx[..., 1]
    out = None
    for b, t in enumerate(bucket_targets):
        sel = bucket == b
        y = lora_delta(x, t["A"], t["B"], torch.where(sel, local, 0),
                       scaling, tp)
        y = torch.where(sel[:, None, None], y, 0.0)
        out = y if out is None else out + y
    return out


def _lora_delta_sgmv(x, target, idx, scaling, block_t, tp):
    """Padded-bank kernel form of ``lora_delta``: token-major flatten, one
    ``sgmv_fused`` launch (B1), unflatten. At tp > 1: B3a on the rank's d
    slice, one all-reduce of the (T_pad, r) h, B3b on its d_out
    columns."""
    x2, (B_, S_) = rows_to_tokens(x)
    tok = idx.repeat_interleave(S_)
    bt = 16 if block_t is None else block_t
    A, B = target["A"].to(x.dtype), target["B"].to(x.dtype)
    if tp_size(tp) == 1:
        y = sgmv_fused(x2, A, B, tok, scaling=scaling, block_t=bt)
    else:
        dest, block_adapter, x_pad = segment_layout(
            _local_x(x2, A, tp), tok, A.shape[0], bt)
        h = all_reduce_(sgmv_shrink(
            x_pad, A, block_adapter, block_t=bt,
            block_live=live_rows(dest, x_pad.shape[0], bt)), tp)
        y = sgmv_expand(h, B, block_adapter, block_t=bt)[dest.long()] \
            * scaling
    return tokens_to_rows(y, B_, S_)


def _lora_delta_sgmv_bucketed(x, bucket_targets, idx, scaling, block_t,
                              tp):
    """Bucketed kernel form: every batch row is its own "adapter"
    (adapter_bucket/adapter_local taken straight from the (Bt, 2) idx), so
    the whole heterogeneous delta is ONE ``sgmv_bucketed_fused`` launch
    (B2) with each row's tokens at its own bucket's rank, at the block
    size of ``kernels.tune.block_plan`` when ``block_t`` is None. At tp >
    1 (block_t 16 unless given, as the JAX package's coshard branch): B4a
    on the rank's d slice of every bucket's A, one all-reduce of the
    (T_pad, max_r) h, B4b on its d_out columns of every B."""
    x2, (B_, S_) = rows_to_tokens(x)
    tok = torch.arange(B_, dtype=torch.int32,
                       device=x.device).repeat_interleave(S_)
    A_banks = [t["A"].to(x.dtype) for t in bucket_targets]
    B_banks = [t["B"].to(x.dtype) for t in bucket_targets]
    if tp_size(tp) == 1:
        y = sgmv_bucketed_fused(x2, tuple(zip(A_banks, B_banks)), tok,
                                idx[:, 0], idx[:, 1], scaling=scaling,
                                block_t=block_t)
    else:
        bt = 16 if block_t is None else block_t
        dest, block_bucket, block_row, x_pad = bucketed_layout(
            _local_x(x2, A_banks[0], tp), tok, idx[:, 0], idx[:, 1],
            len(A_banks), bt)
        h = all_reduce_(sgmv_multibank_shrink(
            x_pad, A_banks, block_bucket, block_row, block_t=bt,
            block_live=live_rows(dest, x_pad.shape[0], bt)), tp)
        y = sgmv_multibank_expand(h, B_banks, block_bucket, block_row,
                                  block_t=bt)[dest.long()] * scaling
    return tokens_to_rows(y, B_, S_)


def make_lora_cb(bank_layer, idx, scaling: float = 1.0, *,
                 kernel: str = "einsum", block_t=None, tp=None,
                 gathered=()):
    """Bind one layer's bank slice and per-row adapter indices into the
    projection hook used by the attention blocks.

    ``bank_layer`` is {target: {"A","B"}} for a padded bank, or a tuple of
    such dicts (one per rank bucket) for a bucketed bank; ``idx`` is the
    matching ``LoRABank.lora_idx`` output. ``kernel`` selects "einsum"
    (gather-einsum) or "sgmv" (the hand-written kernels; their plain
    versions on CPU tensors). ``block_t=None`` means the bucketed path's
    ``kernels.tune.block_plan`` at tp = 1, else 16. ``tp``: this
    rank's ``TensorParallel`` when ``bank_layer`` is its co-sharded slice
    (see the module docstring); the deltas of the targets in
    ``gathered`` are then all-gathered to full width."""
    if bank_layer is None:
        return None
    if kernel not in ("einsum", "sgmv"):
        raise ValueError(f"unknown lora kernel {kernel!r}")

    def delta(name, x):
        if isinstance(bank_layer, (tuple, list)):
            targets = [bk.get(name) for bk in bank_layer]
            if any(t is None for t in targets):
                return 0.0
            if kernel == "sgmv":
                return _lora_delta_sgmv_bucketed(x, targets, idx, scaling,
                                                 block_t, tp)
            return lora_delta_bucketed(x, targets, idx, scaling, tp)
        t = bank_layer.get(name)
        if t is None:
            return 0.0
        if kernel == "sgmv":
            return _lora_delta_sgmv(x, t, idx, scaling, block_t, tp)
        return lora_delta(x, t["A"], t["B"], idx, scaling, tp)

    def cb(name, x):
        y = delta(name, x)
        if name in gathered and isinstance(y, torch.Tensor):
            y = all_gather_(y, tp)
        return y

    # inside a traced launch every call of the hook counts as "lora"
    parts = obs_host.PARTS
    return cb if parts is None else parts.timed("lora", cb)


def apply_bank_sgmv(x, bank, name: str, layer: int, token_adapter, *,
                    scaling: float = 1.0, block_t=None, fused: bool = True):
    """Kernel path for token-major layouts: x: (T, d) tokens,
    token_adapter: (T,) *global* adapter rows of ``bank`` (a LoRABank);
    the delta of target ``name`` at ``layer``. ``block_t=None`` means the
    plan of ``kernels.tune.block_plan`` for the fused bucketed path, as in
    the JAX package, and 16 elsewhere.

    Padded banks run ``sgmv_fused`` (kernel B1) over the whole token set
    at the bank's max rank; bucketed banks run ``sgmv_bucketed_fused``
    (kernel B2), each bucket's tokens at the bucket's own rank, in one
    launch. ``fused=False`` selects the unfused dispatchers on kernels
    B3a/B3b: ``sgmv`` for padded banks, the host loop
    ``sgmv_rank_bucketed`` for bucketed ones. Both give the same numbers
    bit for bit. The bank is cast to x's type, as ``make_lora_cb`` does."""
    bt = 16 if block_t is None else block_t
    if bank.mode == "padded":
        t = bank.data[name]
        fn = sgmv_fused if fused else sgmv
        return fn(x, t["A"][layer].to(x.dtype), t["B"][layer].to(x.dtype),
                  token_adapter, scaling=scaling, block_t=bt)
    banks = [(bk[name]["A"][layer].to(x.dtype),
              bk[name]["B"][layer].to(x.dtype)) for bk in bank.data]
    if fused:
        return sgmv_bucketed_fused(x, banks, token_adapter,
                                   bank.adapter_bucket, bank.adapter_local,
                                   scaling=scaling, block_t=block_t)
    return sgmv_rank_bucketed(x, banks, token_adapter, bank.adapter_bucket,
                              adapter_local=bank.adapter_local,
                              scaling=scaling, block_t=bt)
