"""Dispatch wrappers around the SGMV kernels: segment preparation (sort by
adapter, pad segments to whole blocks), kernel launch, and scatter-back.
The counterpart of the JAX package's ``kernels/ops.py``.

``sgmv_fused`` is the LoRA delta y = (x @ A[aid]) @ B[aid] * scaling for
a ragged multi-adapter token batch on the fused kernel B1 (padded bank);
``sgmv_bucketed_fused`` is the same contract for a rank-bucketed bank set
on kernel B2, tokens laid out bucket-major so each bucket's blocks run at
its own rank in one launch. The segment layout is computed on the device
with no host sync (stable argsort, scatter-add counts, cumsum), so the
engine's k-step decode keeps one sync per k tokens.

``padded_segments`` / ``bucketed_segments`` build everything of a token
batch's layout but x: where each token goes (``dest``), each block's
adapter (or bucket and bank row), each block's live rows (``live_rows``:
the shrink kernels skip the rest, and spare blocks altogether) and
``T_pad``. The dispatchers build it in every call unless they are handed
one (``layout=``); the serving engine hands them one that
``lora/batched.py:LayoutPlan`` built once for the whole batch, since it
depends on the batch's adapter indices and never on x. A call then only
scatters x into the padded layout, launches, and gathers the rows back.
``segment_layout`` / ``bucketed_layout`` give a batch's layout with x
already scattered, for the callers that time or check a kernel on it.
``sgmv_bucketed_fused`` takes its ``block_t`` from ``tune.block_plan``
(``plan_block_t``) when given none, as the JAX package's does.

``sgmv`` (and ``bgmv``, its block_t = 1 decode form) computes the same
delta on the unfused pair B3a/B3b, bit for bit equal to ``sgmv_fused``;
``sgmv_rank_bucketed`` is the host-loop oracle that ``sgmv_bucketed_fused``
equals bit for bit. Neither is on the engine's path.
"""
from __future__ import annotations

import torch

from . import tune
from .ref import sgmv_ref
from .sgmv import (sgmv_expand, sgmv_fused_blocks, sgmv_multibank_blocks,
                   sgmv_shrink)


def _prepare_core(token_adapter, key, n_keys: int, block_t: int,
                  T_pad: int):
    """Shared segment layout: sort tokens by ``key``, give each key a
    whole number of ``block_t`` blocks. Returns (dest, block_adapter)
    where ``block_adapter`` holds the *adapter id* of each block (spare
    blocks hold 0)."""
    T = token_adapter.shape[0]
    dev = token_adapter.device
    key = key.long()
    order = torch.argsort(key, stable=True)          # jnp.argsort is stable
    aid_s = token_adapter[order]
    key_s = key[order]
    # bincount would sync the host for its output length; a scatter-add
    # into n_keys bins does not
    counts = torch.zeros(n_keys, dtype=torch.long, device=dev).scatter_add_(
        0, key, torch.ones_like(key))
    padded = (counts + block_t - 1) // block_t * block_t
    offs = torch.cumsum(padded, 0) - padded
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T, device=dev) - starts[key_s]
    dest_sorted = offs[key_s] + rank                 # (T,)
    dest = torch.empty(T, dtype=torch.int32, device=dev)
    dest[order] = dest_sorted.to(torch.int32)
    block_adapter = torch.zeros(T_pad // block_t, dtype=torch.int32,
                                device=dev)
    block_adapter[dest_sorted // block_t] = aid_s.to(torch.int32)
    return dest, block_adapter


def prepare_segments(token_adapter, n_adapters: int, block_t: int = 16):
    """Sort tokens by adapter; give each adapter a whole number of
    ``block_t`` blocks.

    Returns (dest, block_adapter):
      dest          : (T,) position of each (original-order) token in the
                      padded, segment-blocked layout
      block_adapter : (T_pad // block_t,) adapter id per block
    T_pad = ``padded_len(T, n_adapters, block_t)``.
    """
    T = token_adapter.shape[0]
    T_pad = padded_len(T, n_adapters, block_t)
    return _prepare_core(token_adapter, token_adapter, n_adapters, block_t,
                         T_pad)


def prepare_segments_bucketed(token_adapter, adapter_bucket,
                              n_adapters: int, n_buckets: int = 1,
                              block_t: int = 16):
    """Bucket-major form: tokens sorted by (bucket, adapter) so each rank
    bucket's blocks are contiguous. Same return contract and T_pad as
    ``prepare_segments``."""
    T = token_adapter.shape[0]
    T_pad = padded_len(T, n_adapters, block_t)
    token_adapter = token_adapter.long()
    key = adapter_bucket.long()[token_adapter] * n_adapters + token_adapter
    return _prepare_core(token_adapter, key, n_buckets * n_adapters,
                         block_t, T_pad)


def padded_len(T: int, n_adapters: int, block_t: int) -> int:
    """Padded token count: every adapter may waste < block_t slots."""
    return T + n_adapters * block_t


def live_rows(dest, T_pad: int, block_t: int):
    """(T_pad // block_t,) int32: the tokens each whole block holds, a
    scatter-add of ones at ``dest // block_t`` on the device (no host
    sync). A block's tokens fill it from its first row, so the count
    bounds its live rows; spare blocks count 0."""
    blk = dest.long() // block_t
    return torch.zeros(T_pad // block_t, dtype=torch.int32,
                       device=dest.device).scatter_add_(
        0, blk, torch.ones_like(blk, dtype=torch.int32))


def scatter_rows(x, dest, T_pad):
    """(T, d) rows -> the zero-padded (T_pad, d) segment-blocked layout."""
    x_pad = x.new_zeros((T_pad, x.shape[1]))
    x_pad[dest.long()] = x
    return x_pad


def padded_segments(token_adapter, n_adapters: int, block_t: int):
    """A token batch laid out for a padded bank: (dest (T,) int64,
    block_adapter, live, T_pad), ``live`` the ``live_rows`` of each
    block."""
    T_pad = padded_len(token_adapter.shape[0], n_adapters, block_t)
    dest, block_adapter = prepare_segments(token_adapter, n_adapters,
                                           block_t)
    dest = dest.long()
    return dest, block_adapter, live_rows(dest, T_pad, block_t), T_pad


def bucketed_segments(token_adapter, adapter_bucket, adapter_local,
                      n_buckets: int, block_t: int):
    """A token batch laid out bucket-major for a rank-bucketed bank:
    (dest (T,) int64, block_bucket, block_row, live, T_pad).
    adapter_local=None: every bucket bank is indexed by the global
    adapter id."""
    Na = adapter_bucket.shape[0]
    T_pad = padded_len(token_adapter.shape[0], Na, block_t)
    dest, block_adapter = prepare_segments_bucketed(
        token_adapter, adapter_bucket, Na, n_buckets, block_t)
    dest = dest.long()
    local = torch.arange(Na, dtype=torch.int32,
                         device=adapter_bucket.device) \
        if adapter_local is None else adapter_local.to(torch.int32)
    ba = block_adapter.long()
    return (dest, adapter_bucket.to(torch.int32)[ba], local[ba],
            live_rows(dest, T_pad, block_t), T_pad)


def segment_layout(x, token_adapter, n_adapters: int, block_t: int):
    """x's rows in the padded bank's layout: (dest, block_adapter,
    x_pad)."""
    dest, block_adapter, _, T_pad = padded_segments(
        token_adapter, n_adapters, block_t)
    return dest, block_adapter, scatter_rows(x, dest, T_pad)


def bucketed_layout(x, token_adapter, adapter_bucket, adapter_local,
                    n_buckets: int, block_t: int):
    """x's rows in a rank-bucketed bank's bucket-major layout: (dest,
    block_bucket, block_row, x_pad). adapter_local=None: every bucket
    bank is indexed by the global adapter id."""
    dest, block_bucket, block_row, _, T_pad = bucketed_segments(
        token_adapter, adapter_bucket, adapter_local, n_buckets, block_t)
    return dest, block_bucket, block_row, scatter_rows(x, dest, T_pad)


def sgmv(x, A, B, token_adapter, *, scaling: float = 1.0,
         block_t: int = 16):
    """x: (T, d_in); A: (Na, d_in, r); B: (Na, r, d_out); token_adapter:
    (T,) int. The LoRA delta on the unfused pair: kernel B3a writes the
    (T_pad, r) intermediate, kernel B3b expands it. Returns (T, d_out),
    bit for bit ``sgmv_fused``'s."""
    dest, block_adapter, live, T_pad = padded_segments(
        token_adapter, A.shape[0], block_t)
    h = sgmv_shrink(scatter_rows(x, dest, T_pad), A, block_adapter,
                    block_t=block_t, block_live=live)
    y_pad = sgmv_expand(h, B, block_adapter, block_t=block_t)
    return y_pad[dest] * scaling


def bgmv(x, A, B, token_adapter, *, scaling: float = 1.0):
    """Decode-time per-token gather (Punica BGMV): ``sgmv`` at
    block_t = 1."""
    return sgmv(x, A, B, token_adapter, scaling=scaling, block_t=1)


def sgmv_rank_bucketed(x, banks, token_adapter, adapter_rank_bucket, *,
                       adapter_local=None, scaling: float = 1.0,
                       block_t: int = 16):
    """Host-loop rank-bucketed dispatcher, kept as the oracle that
    ``sgmv_bucketed_fused`` equals bit for bit.

    banks: sequence of (A_b, B_b) per bucket; adapter_rank_bucket: (Na,)
    adapter -> bucket; adapter_local: optional (Na,) adapter -> row of
    its bucket's bank (None: every bucket bank is indexed by the global
    id). Each bucket's tokens are compacted into a dense sub-batch that
    runs ``sgmv`` at the bucket's rank, then scattered back: two launches
    per non-empty bucket. Reading ``token_adapter`` on the host to find
    the buckets is this oracle's one sync, which is why the engine's
    decode path never calls it."""
    T = x.shape[0]
    d_out = banks[0][1].shape[-1]
    # analysis: ignore[host-sync] the oracle's one sync, off the engine
    tok_adapter = token_adapter.long().cpu()
    tok_bucket = adapter_rank_bucket.long().cpu()[tok_adapter]
    local = tok_adapter if adapter_local is None else \
        adapter_local.long().cpu()[tok_adapter]
    out = x.new_zeros((T, d_out))
    for i, (A, B) in enumerate(banks):
        sel = torch.nonzero(tok_bucket == i).flatten()
        if sel.numel() == 0:
            continue
        sel_dev = sel.to(x.device)
        y = sgmv(x[sel_dev], A, B, local[sel].to(x.device, torch.int32),
                 scaling=scaling, block_t=block_t)
        out[sel_dev] = y.to(out.dtype)
    return out


def sgmv_fused(x, A, B, token_adapter, *, scaling: float = 1.0,
               block_t: int = 16, layout=None):
    """x: (T, d_in); A: (Na, d_in, r); B: (Na, r, d_out); token_adapter:
    (T,) int. The LoRA delta on kernel B1, one launch. Returns
    (T, d_out). ``layout``: ``padded_segments(token_adapter, Na,
    block_t)`` built beforehand, else built here."""
    if layout is None:
        layout = padded_segments(token_adapter, A.shape[0], block_t)
    dest, block_adapter, live, T_pad = layout
    y_pad = sgmv_fused_blocks(scatter_rows(x, dest, T_pad), A, B,
                              block_adapter, block_t=block_t,
                              block_live=live)
    return y_pad[dest] * scaling


def plan_block_t(x, banks) -> int:
    """``tune.block_plan``'s ``block_t`` for x's rows on a rank-bucketed
    bank set (from shapes alone: no host sync)."""
    return tune.block_plan(x.shape[0], x.shape[1], banks[0][1].shape[-1],
                           tuple(A.shape[-1] for A, _ in banks),
                           tuple(A.shape[0] for A, _ in banks))


def sgmv_bucketed_fused(x, banks, token_adapter, adapter_bucket,
                        adapter_local=None, *, scaling: float = 1.0,
                        block_t=None, layout=None):
    """Rank-bucketed LoRA delta in one launch of kernel B2.

    banks: sequence of (A_b (Na_b, d, r_b), B_b (Na_b, r_b, d_out)) in
    ascending bucket order; adapter_bucket: (Na,) adapter -> bucket;
    adapter_local: (Na,) adapter -> row of its bucket's bank (None: every
    bucket bank is indexed by the global id). ``block_t=None`` takes the
    block size from ``tune.block_plan`` on the bank signature (the same as
    the JAX package's plan, from shapes alone: no host sync); an explicit
    value pins it. The JAX plan's bank residency is a TPU VMEM plan that
    changes no number, so it has no counterpart here. ``layout``:
    ``bucketed_segments(token_adapter, adapter_bucket, adapter_local,
    len(banks), block_t)`` built beforehand at the ``block_t`` given,
    else built here."""
    banks = tuple((A, B) for A, B in banks)
    if block_t is None:
        block_t = plan_block_t(x, banks)
    if layout is None:
        layout = bucketed_segments(token_adapter, adapter_bucket,
                                   adapter_local, len(banks), block_t)
    dest, block_bucket, block_row, live, T_pad = layout
    y_pad = sgmv_multibank_blocks(
        scatter_rows(x, dest, T_pad), banks, block_bucket, block_row,
        block_t=block_t, block_live=live)
    return y_pad[dest] * scaling


def sgmv_reference(x, A, B, token_adapter, scaling: float = 1.0):
    """Exported oracle (tests compare kernels against this)."""
    return sgmv_ref(x, A, B, token_adapter, scaling)
