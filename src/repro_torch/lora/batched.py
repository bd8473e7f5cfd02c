"""Batched heterogeneous-adapter application, the counterpart of the JAX
package's ``lora/batched.py`` (single device: the mesh co-sharding
branches wait for ROADMAP queue A item 10).

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import (sgmv, sgmv_bucketed_fused, sgmv_fused,
                                     sgmv_rank_bucketed)
from repro_torch.models.common import rows_to_tokens, tokens_to_rows


def lora_delta(x, A, B, idx, scaling: float = 1.0):
    """x: (Bt, S, d); A: (Na, d, r); B: (Na, r, out); idx: (Bt,) int.

    Every row pays max-rank (r = bank rank) cost regardless of its
    adapter's true rank (BGMV semantics)."""
    idx = idx.long()
    h = torch.einsum("bsd,bdr->bsr", x, A[idx].to(x.dtype))
    out = torch.einsum("bsr,bro->bso", h, B[idx].to(x.dtype))
    return out * scaling


def lora_delta_bucketed(x, bucket_targets, idx, scaling: float = 1.0):
    """x: (Bt, S, d); bucket_targets: per-bucket {"A","B"} slices (bucket
    b at rank r_b); idx: (Bt, 2) int of (bucket, local).

    Each bucket runs a gather-einsum at its own rank over the full row set
    with out-of-bucket rows masked to zero."""
    bucket, local = idx[..., 0], idx[..., 1]
    out = None
    for b, t in enumerate(bucket_targets):
        sel = bucket == b
        y = lora_delta(x, t["A"], t["B"], torch.where(sel, local, 0),
                       scaling)
        y = torch.where(sel[:, None, None], y, 0.0)
        out = y if out is None else out + y
    return out


def _lora_delta_sgmv(x, target, idx, scaling, block_t):
    """Padded-bank kernel form of ``lora_delta``: token-major flatten, one
    ``sgmv_fused`` launch, unflatten."""
    x2, (B_, S_) = rows_to_tokens(x)
    tok = idx.repeat_interleave(S_)
    bt = 16 if block_t is None else block_t
    y = sgmv_fused(x2, target["A"].to(x.dtype), target["B"].to(x.dtype),
                   tok, scaling=scaling, block_t=bt)
    return tokens_to_rows(y, B_, S_)


def _lora_delta_sgmv_bucketed(x, bucket_targets, idx, scaling, block_t):
    """Bucketed kernel form: every batch row is its own "adapter"
    (adapter_bucket/adapter_local taken straight from the (Bt, 2) idx), so
    the whole heterogeneous delta is ONE ``sgmv_bucketed_fused`` launch
    with each row's tokens at its own bucket's rank."""
    x2, (B_, S_) = rows_to_tokens(x)
    tok = torch.arange(B_, dtype=torch.int32,
                       device=x.device).repeat_interleave(S_)
    banks = tuple((t["A"].to(x.dtype), t["B"].to(x.dtype))
                  for t in bucket_targets)
    y = sgmv_bucketed_fused(x2, banks, tok, idx[:, 0], idx[:, 1],
                            scaling=scaling,
                            block_t=16 if block_t is None else block_t)
    return tokens_to_rows(y, B_, S_)


def make_lora_cb(bank_layer, idx, scaling: float = 1.0, *,
                 kernel: str = "einsum", block_t=None):
    """Bind one layer's bank slice and per-row adapter indices into the
    projection hook used by the attention blocks.

    ``bank_layer`` is {target: {"A","B"}} for a padded bank, or a tuple of
    such dicts (one per rank bucket) for a bucketed bank; ``idx`` is the
    matching ``LoRABank.lora_idx`` output. ``kernel`` selects "einsum"
    (gather-einsum) or "sgmv" (the hand-written kernels; their plain
    versions on CPU tensors). ``block_t=None`` means 16."""
    if bank_layer is None:
        return None
    if kernel not in ("einsum", "sgmv"):
        raise ValueError(f"unknown lora kernel {kernel!r}")

    if isinstance(bank_layer, (tuple, list)):
        def cb_bucketed(name, x):
            targets = [bk.get(name) for bk in bank_layer]
            if any(t is None for t in targets):
                return 0.0
            if kernel == "sgmv":
                return _lora_delta_sgmv_bucketed(x, targets, idx, scaling,
                                                 block_t)
            return lora_delta_bucketed(x, targets, idx, scaling)

        return cb_bucketed

    def cb(name, x):
        t = bank_layer.get(name)
        if t is None:
            return 0.0
        if kernel == "sgmv":
            return _lora_delta_sgmv(x, t, idx, scaling, block_t)
        return lora_delta(x, t["A"], t["B"], idx, scaling)

    return cb


def apply_bank_sgmv(x, bank, name: str, layer: int, token_adapter, *,
                    scaling: float = 1.0, block_t=None, fused: bool = True):
    """Kernel path for token-major layouts: x: (T, d) tokens,
    token_adapter: (T,) *global* adapter rows of ``bank`` (a LoRABank);
    the delta of target ``name`` at ``layer``. ``block_t=None`` means 16.

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
                                   scaling=scaling, block_t=bt)
    return sgmv_rank_bucketed(x, banks, token_adapter, bank.adapter_bucket,
                              adapter_local=bank.adapter_local,
                              scaling=scaling, block_t=bt)
