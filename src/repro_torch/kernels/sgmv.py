"""Wrappers of the hand-written Hopper SGMV kernels (``csrc/sgmv.cu``)
and their plain-torch versions.

* ``sgmv_fused_blocks`` (B1) replaces the JAX package's Pallas
  ``kernels/sgmv.py:sgmv_fused_blocks``: the padded bank, one fused
  shrink+expand over a segment-blocked token layout.
* ``sgmv_multibank_blocks`` (B2) replaces ``sgmv_multibank_blocks``: the
  rank-bucketed bank set in one launch, each block at its own bucket's
  rank.
* ``sgmv_shrink`` (B3a) and ``sgmv_expand`` (B3b) replace the unfused
  pair ``sgmv_shrink`` / ``sgmv_expand``: h = x_blk @ A[aid] to a
  (T_pad, r) tensor in x's type, then y = h_blk @ B[aid]. The kernels
  share B1's shrink and expand code, so the pair gives B1's output bit
  for bit.
* ``sgmv_multibank_shrink`` (B4a) and ``sgmv_multibank_expand`` (B4b)
  replace the split multibank pair of the same names, B2 cut in two for
  a tensor-parallel engine: h (T_pad, max_r) in x's type, each block at
  its bucket's rank and the columns above it zero (they enter the
  all-reduce across ranks), then y = h_blk[:, :r_b] @ B_b[row]. At one
  rank the pair gives B2's output bit for bit.

B1, B2, B3a and B4a run one shrink: each token block is a cluster of C
thread blocks, each summing x_blk @ A over its own d-slice, and the C
partials are added in rank order before h is rounded to x's type. C is
``shrink_split(d, dtype)``, the one place that decides it, so every
kernel sums an entry of h in the same order. B1, B2, B3b and B4b run one
expand: in bf16 on the tensor cores, the 16-wide k chunks of the rank in
order, each one ``mma`` product accumulated in fp32 (chunks zero past
the rank); in fp32 an FMA chain over the rank in order. An output's sum
never depends on the kernel, the bank's rank or block_t, so the
bit-identity promises above hold. B3b and B4b tile the output columns
in ``EXPAND_COLS`` a thread block, whatever ``block_o``.

The shrink kernels (B1, B2, B3a, B4a) take ``block_live``, each block's
count of live rows: the segment layout fills a block from its first row,
so its live rows are a prefix (``ops.live_rows`` counts them on the
device). Rows at or past the count are written as zeros and cost no
work; a spare block (count 0) reads no weights. ``block_live=None``
means every row of every block is live. B2 takes ``block_t`` up to 64
(``tune.SUPPORTED_BLOCK_T``: a block of 32 or 64 rows runs as 16-row
tiles over weights it reads once); the other kernels take 1..16.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises. On every device it refuses an input that
requires grad while grad mode is on (``build.refuse_autograd``: no
kernel has a backward). Each wrapper counts its kernel launches in
a plain integer attribute, ``launches``. The ``*_ref`` plain versions run
the same block layout with the same fp32 sums (in torch's order, not the
kernels' slices; a block over 16 rows as 16-row tiles), the same cast of
the intermediate ``h`` to the input type between the two products, and
the same zero rows past each block's live count.
"""
from __future__ import annotations

import ctypes

import torch

from .build import launch as _launch
from .build import refuse_autograd
from .tune import SUPPORTED_BLOCK_T, check_block_t

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_CARD = "cuda"                     # the device type the kernels run on
MAX_BLOCK_T = 16                   # every kernel but B2
TILE_T = 16                        # rows of a kernel's token tile
MAX_RANK = 128
MAX_BUCKETS = 8
SLICE = 128                        # d-slice a cluster block aims for
EXPAND_COLS = 64                   # B3b/B4b: output columns a thread block
FUSED_EXPAND_COLS = 256            # B1/B2: columns a cluster block's pass
WIDE_EXPAND_COLS = 128             # B2 at block_t 32 and 64: the same


def shrink_split(d: int, dtype) -> int:
    """C, the number of thread blocks (a cluster) that share one token
    block's shrink, each summing x_blk @ A over a d-slice of ceil(d / C)
    rows: the least of 4, 8 and 16 whose slice is at most ``SLICE`` rows,
    else 16 (4096 and 2048 -> 16, 1024 -> 8, 512 and less -> 4). On the
    H100, B1's decode call at d = 4096 ran fastest at 16
    (``chip_smoke.py`` phase 3 times it at 4, 8 and 16). A function of d
    and the type only: never of the rank, the bucket, block_t or the
    kernel, so that every SGMV kernel sums an entry of h in the same
    order."""
    if d < 1 or dtype not in _DTYPE_CODE:
        raise ValueError(f"no shrink split for d={d}, dtype={dtype}")
    split = 4
    while split < 16 and d > split * SLICE:
        split *= 2
    return split


def _live_mask(T_pad, block_live, block_t, device):
    """(T_pad,) bool: the rows of each whole block below its live count
    (every row of a whole block when ``block_live`` is None)."""
    nblocks = T_pad // block_t
    keep = torch.zeros(T_pad, dtype=torch.bool, device=device)
    if block_live is None:
        keep[:nblocks * block_t] = True
    else:
        t = torch.arange(block_t, device=device)
        keep[:nblocks * block_t] = (
            t[None, :] < block_live[:nblocks, None].long()).flatten()
    return keep


def _block_products(x_pad, W, block_adapter, block_t, block_live=None):
    """Each whole ``block_t``-row block i of x_pad times
    W[block_adapter[i]], fp32 sums rounded to x's type, a block of a
    multiple of ``TILE_T`` rows as tiles of ``TILE_T`` (as B2 runs its
    large blocks); rows past the last whole block and past a block's live
    count are zero."""
    T_pad, d = x_pad.shape
    nblocks = T_pad // block_t
    n = nblocks * block_t
    tile = TILE_T if block_t % TILE_T == 0 else block_t
    idx = block_adapter[:nblocks].long().repeat_interleave(block_t // tile)
    xb = x_pad[:n].reshape(n // tile, tile, d).float()
    y = torch.bmm(xb, W[idx].float()).to(x_pad.dtype)
    out = x_pad.new_zeros((T_pad, W.shape[-1]))
    out[:n] = y.reshape(n, -1)
    if block_live is not None:
        keep = _live_mask(T_pad, block_live, block_t, x_pad.device)
        out = torch.where(keep[:, None], out, 0)
    return out


def sgmv_shrink_blocks_ref(x_pad, A, block_adapter, *, block_t: int = 16,
                           block_live=None):
    """Plain version of B3a. x_pad: (T_pad, d); A: (Na, d, r). Returns h
    (T_pad, r)."""
    return _block_products(x_pad, A, block_adapter, block_t, block_live)


def sgmv_expand_blocks_ref(h_pad, B, block_adapter, *, block_t: int = 16):
    """Plain version of B3b. h_pad: (T_pad, r); B: (Na, r, d_out).
    Returns (T_pad, d_out)."""
    return _block_products(h_pad, B, block_adapter, block_t)


def sgmv_fused_blocks_ref(x_pad, A, B, block_adapter, *, block_t: int = 16,
                          block_live=None):
    """Plain version of B1, the plain B3a then B3b. x_pad: (T_pad, d);
    A: (Na, d, r); B: (Na, r, d_out); block_adapter / block_live:
    (T_pad // block_t,) int. Returns (T_pad, d_out); rows past the last
    whole block and past a block's live count are zero."""
    h = sgmv_shrink_blocks_ref(x_pad, A, block_adapter, block_t=block_t,
                               block_live=block_live)
    return sgmv_expand_blocks_ref(h, B, block_adapter, block_t=block_t)


def _bucket_rows(T_pad, block_bucket, block_row, b, block_t, device):
    """Bucket b's blocks: (rows of other buckets' blocks clamped to 0, a
    (T_pad,) mask of the rows in bucket b's whole blocks)."""
    nblocks = T_pad // block_t
    sel = block_bucket[:nblocks].long() == b
    keep = torch.zeros(T_pad, dtype=torch.bool, device=device)
    keep[:nblocks * block_t] = sel.repeat_interleave(block_t)
    return torch.where(sel, block_row[:nblocks].long(), 0), keep


def sgmv_multibank_blocks_ref(x_pad, banks, block_bucket, block_row, *,
                              block_t: int = 16, block_live=None):
    """Plain version of B2, at any ``block_t``. banks: sequence of
    (A_b (Na_b, d, r_b), B_b (Na_b, r_b, d_out)) in ascending bucket
    order; block_bucket / block_row / block_live: (T_pad // block_t,)
    int. Each bucket runs over every block (rows of other buckets clamp
    to row 0, as the Pallas index maps do) and keeps the blocks that are
    its own: no host sync."""
    out = x_pad.new_zeros((x_pad.shape[0], banks[0][1].shape[-1]))
    for b, (A, B) in enumerate(banks):
        row, keep = _bucket_rows(x_pad.shape[0], block_bucket, block_row, b,
                                 block_t, x_pad.device)
        y = sgmv_fused_blocks_ref(x_pad, A, B, row, block_t=block_t,
                                  block_live=block_live)
        out = torch.where(keep[:, None], y, out)
    return out


def sgmv_multibank_shrink_blocks_ref(x_pad, A_banks, block_bucket,
                                     block_row, *, block_t: int = 16,
                                     block_live=None):
    """Plain version of B4a. x_pad: (T_pad, d_local); A_banks: sequence of
    A_b (Na_b, d_local, r_b). Returns h (T_pad, max_r): each whole block's
    shrink at its bucket's rank on its live rows, zeros elsewhere."""
    max_r = max(A.shape[-1] for A in A_banks)
    h = x_pad.new_zeros((x_pad.shape[0], max_r))
    for b, A in enumerate(A_banks):
        row, keep = _bucket_rows(x_pad.shape[0], block_bucket, block_row, b,
                                 block_t, x_pad.device)
        y = _block_products(x_pad, A, row, block_t, block_live)
        h[:, :A.shape[-1]] = torch.where(keep[:, None], y,
                                         h[:, :A.shape[-1]])
    return h


def sgmv_multibank_expand_blocks_ref(h_pad, B_banks, block_bucket,
                                     block_row, *, block_t: int = 16):
    """Plain version of B4b. h_pad: (T_pad, max_r); B_banks: sequence of
    B_b (Na_b, r_b, d_out_local). Returns (T_pad, d_out_local)."""
    out = h_pad.new_zeros((h_pad.shape[0], B_banks[0].shape[-1]))
    for b, B in enumerate(B_banks):
        row, keep = _bucket_rows(h_pad.shape[0], block_bucket, block_row, b,
                                 block_t, h_pad.device)
        y = _block_products(h_pad[:, :B.shape[1]].contiguous(), B, row,
                            block_t)
        out = torch.where(keep[:, None], y, out)
    return out


def _check_x(x_pad, block_t, max_block_t=MAX_BLOCK_T):
    if x_pad.device.type != _CARD:
        raise ValueError(f"SGMV kernels run on CUDA or CPU tensors, got "
                         f"{x_pad.device}")
    if x_pad.dtype not in _DTYPE_CODE:
        raise TypeError(f"x_pad dtype {x_pad.dtype}: the kernels take "
                        "float32 or bfloat16")
    if x_pad.dim() != 2 or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous (T_pad, d) tensor")
    if not 1 <= block_t <= max_block_t:
        raise ValueError(f"block_t={block_t} outside 1..{max_block_t}")


def _live_arg(x_pad, block_live, nblocks, block_t):
    """The kernel's live-row counts: ``block_live`` checked, or every row
    of every block when it is None."""
    if block_live is None:
        return torch.full((nblocks,), block_t, dtype=torch.int32,
                          device=x_pad.device)
    _check_index(x_pad, block_live, nblocks, "block_live")
    return block_live


def _check_weight(x_pad, W, name, width, rank_axis):
    """One bank: A (Na, d, r) with rank_axis 2, or B (Na, r, d_out) with
    rank_axis 1; ``width`` is what the bank's axis 1 must equal (x's last
    dim for A, the rank for B)."""
    if W.device != x_pad.device or W.dtype != x_pad.dtype:
        raise ValueError(f"{name} must be {x_pad.dtype} on {x_pad.device}, "
                         f"got {W.dtype} on {W.device}")
    if W.dim() != 3 or not W.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 3-D tensor")
    if W.shape[1] != width:
        raise ValueError(f"{name} {tuple(W.shape)} does not fit (*, {width})")
    r = W.shape[rank_axis]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")


def _check_bank(x_pad, A, B):
    _check_weight(x_pad, A, "A", x_pad.shape[1], 2)
    _check_weight(x_pad, B, "B", A.shape[-1], 1)
    if B.shape[0] != A.shape[0]:
        raise ValueError(f"bank shapes A {tuple(A.shape)} / B "
                         f"{tuple(B.shape)} hold different adapter counts")


def _check_index(x_pad, t, nblocks, name):
    if t.device != x_pad.device or t.dtype != torch.int32 \
            or t.shape != (nblocks,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({nblocks},) int32 "
                         f"tensor on {x_pad.device}")


def _bucket_ptrs(banks, rank_axis):
    nb = len(banks)
    return ((ctypes.c_void_p * nb)(*[W.data_ptr() for W in banks]),
            (ctypes.c_int * nb)(*[W.shape[rank_axis] for W in banks]))


def _check_n_buckets(banks):
    if not 1 <= len(banks) <= MAX_BUCKETS:
        raise ValueError(f"{len(banks)} buckets outside 1..{MAX_BUCKETS}")


def sgmv_fused_blocks(x_pad, A, B, block_adapter, *, block_t: int = 16,
                      block_live=None):
    """B1: fused shrink+expand over a segment-blocked layout, one launch.
    Returns (T_pad, d_out); on CUDA rows past the last whole block are
    left unwritten (no caller reads them)."""
    refuse_autograd("sgmv_fused_blocks", x_pad, A, B)
    if x_pad.device.type == "cpu":
        return sgmv_fused_blocks_ref(x_pad, A, B, block_adapter,
                                     block_t=block_t, block_live=block_live)
    _check_x(x_pad, block_t)
    _check_bank(x_pad, A, B)
    T_pad, d = x_pad.shape
    r = A.shape[-1]
    d_out = B.shape[-1]
    nblocks = T_pad // block_t
    _check_index(x_pad, block_adapter, nblocks, "block_adapter")
    live = _live_arg(x_pad, block_live, nblocks, block_t)
    out = torch.empty((T_pad, d_out), dtype=x_pad.dtype, device=x_pad.device)
    _launch("sgmv_fused_blocks_launch", x_pad.device,
            _DTYPE_CODE[x_pad.dtype], shrink_split(d, x_pad.dtype),
            x_pad.data_ptr(), A.data_ptr(), B.data_ptr(),
            block_adapter.data_ptr(), live.data_ptr(), out.data_ptr(),
            nblocks, block_t, d, r, d_out)
    sgmv_fused_blocks.launches += 1
    return out


sgmv_fused_blocks.launches = 0


def sgmv_multibank_blocks(x_pad, banks, block_bucket, block_row, *,
                          block_t: int = 16, block_live=None):
    """B2: one launch over a whole rank-bucketed bank set. banks: sequence
    of (A_b (Na_b, d, r_b), B_b (Na_b, r_b, d_out)), at most 8 buckets;
    block_t one of ``tune.SUPPORTED_BLOCK_T`` (1..16, 32, 64). Returns
    (T_pad, d_out) like ``sgmv_fused_blocks``."""
    refuse_autograd("sgmv_multibank_blocks", x_pad, banks)
    check_block_t(block_t)
    if x_pad.device.type == "cpu":
        return sgmv_multibank_blocks_ref(x_pad, banks, block_bucket,
                                         block_row, block_t=block_t,
                                         block_live=block_live)
    _check_x(x_pad, block_t, max(SUPPORTED_BLOCK_T))
    banks = [(A, B) for A, B in banks]
    _check_n_buckets(banks)
    d_out = banks[0][1].shape[-1]
    for A, B in banks:
        _check_bank(x_pad, A, B)
        if B.shape[-1] != d_out:
            raise ValueError("every bucket's B must share d_out")
    T_pad, d = x_pad.shape
    nblocks = T_pad // block_t
    _check_index(x_pad, block_bucket, nblocks, "block_bucket")
    _check_index(x_pad, block_row, nblocks, "block_row")
    live = _live_arg(x_pad, block_live, nblocks, block_t)
    nb = len(banks)
    a_ptrs, ranks = _bucket_ptrs([A for A, _ in banks], 2)
    b_ptrs, _ = _bucket_ptrs([B for _, B in banks], 1)
    out = torch.empty((T_pad, d_out), dtype=x_pad.dtype, device=x_pad.device)
    _launch("sgmv_multibank_blocks_launch", x_pad.device,
            _DTYPE_CODE[x_pad.dtype], shrink_split(d, x_pad.dtype),
            x_pad.data_ptr(), a_ptrs, b_ptrs, ranks, nb,
            block_bucket.data_ptr(), block_row.data_ptr(), live.data_ptr(),
            out.data_ptr(), nblocks, block_t, d, d_out)
    sgmv_multibank_blocks.launches += 1
    return out


sgmv_multibank_blocks.launches = 0


def sgmv_shrink(x_pad, A, block_adapter, *, block_t: int = 16,
                block_live=None):
    """B3a: h = x_blk @ A[block_adapter[i]] for every whole block i.
    Returns (T_pad, r) in x's type; on CUDA rows past the last whole
    block are left unwritten (no caller reads them)."""
    refuse_autograd("sgmv_shrink", x_pad, A)
    if x_pad.device.type == "cpu":
        return sgmv_shrink_blocks_ref(x_pad, A, block_adapter,
                                      block_t=block_t, block_live=block_live)
    _check_x(x_pad, block_t)
    _check_weight(x_pad, A, "A", x_pad.shape[1], 2)
    T_pad, d = x_pad.shape
    r = A.shape[-1]
    nblocks = T_pad // block_t
    _check_index(x_pad, block_adapter, nblocks, "block_adapter")
    live = _live_arg(x_pad, block_live, nblocks, block_t)
    h = torch.empty((T_pad, r), dtype=x_pad.dtype, device=x_pad.device)
    _launch("sgmv_shrink_launch", x_pad.device, _DTYPE_CODE[x_pad.dtype],
            shrink_split(d, x_pad.dtype), x_pad.data_ptr(), A.data_ptr(),
            block_adapter.data_ptr(), live.data_ptr(), h.data_ptr(), nblocks,
            block_t, d, r)
    sgmv_shrink.launches += 1
    return h


sgmv_shrink.launches = 0


def sgmv_expand(h_pad, B, block_adapter, *, block_t: int = 16,
                block_o: int = 2048):
    """B3b: y = h_blk @ B[block_adapter[i]] for every whole block i.
    Returns (T_pad, d_out) in h's type; on CUDA rows past the last whole
    block are left unwritten. ``block_o`` mirrors the JAX call's output
    tile and is validated; on the card it does not shape the grid, which
    is (token blocks, ceil(d_out / EXPAND_COLS)), and d_out is never
    padded."""
    refuse_autograd("sgmv_expand", h_pad, B)
    if h_pad.device.type == "cpu":
        return sgmv_expand_blocks_ref(h_pad, B, block_adapter,
                                      block_t=block_t)
    _check_x(h_pad, block_t)
    _check_weight(h_pad, B, "B", h_pad.shape[1], 1)
    if block_o < 1:
        raise ValueError(f"block_o={block_o} must be positive")
    T_pad, r = h_pad.shape
    d_out = B.shape[-1]
    nblocks = T_pad // block_t
    _check_index(h_pad, block_adapter, nblocks, "block_adapter")
    out = torch.empty((T_pad, d_out), dtype=h_pad.dtype, device=h_pad.device)
    _launch("sgmv_expand_launch", h_pad.device, _DTYPE_CODE[h_pad.dtype],
            h_pad.data_ptr(), B.data_ptr(), block_adapter.data_ptr(),
            out.data_ptr(), nblocks, block_t, r, d_out)
    sgmv_expand.launches += 1
    return out


sgmv_expand.launches = 0


def sgmv_multibank_shrink(x_pad, A_banks, block_bucket, block_row, *,
                          block_t: int = 16, block_live=None):
    """B4a: h = x_blk @ A_b[row] for every whole block, at its bucket's
    rank r_b, columns r_b..max_r zero, and rows past the block's live
    count zero. A_banks: sequence of A_b (Na_b, d_local, r_b), at most 8.
    Returns (T_pad, max_r) in x's type; on CUDA rows past the last whole
    block are left unwritten."""
    A_banks = list(A_banks)
    refuse_autograd("sgmv_multibank_shrink", x_pad, A_banks)
    if x_pad.device.type == "cpu":
        return sgmv_multibank_shrink_blocks_ref(x_pad, A_banks, block_bucket,
                                                block_row, block_t=block_t,
                                                block_live=block_live)
    _check_x(x_pad, block_t)
    _check_n_buckets(A_banks)
    for A in A_banks:
        _check_weight(x_pad, A, "A", x_pad.shape[1], 2)
    T_pad, d = x_pad.shape
    nblocks = T_pad // block_t
    _check_index(x_pad, block_bucket, nblocks, "block_bucket")
    _check_index(x_pad, block_row, nblocks, "block_row")
    live = _live_arg(x_pad, block_live, nblocks, block_t)
    max_r = max(A.shape[-1] for A in A_banks)
    a_ptrs, ranks = _bucket_ptrs(A_banks, 2)
    h = torch.empty((T_pad, max_r), dtype=x_pad.dtype, device=x_pad.device)
    _launch("sgmv_multibank_shrink_launch", x_pad.device,
            _DTYPE_CODE[x_pad.dtype], shrink_split(d, x_pad.dtype),
            x_pad.data_ptr(), a_ptrs, ranks, len(A_banks),
            block_bucket.data_ptr(), block_row.data_ptr(), live.data_ptr(),
            h.data_ptr(), nblocks, block_t, d, max_r)
    sgmv_multibank_shrink.launches += 1
    return h


sgmv_multibank_shrink.launches = 0


def sgmv_multibank_expand(h_pad, B_banks, block_bucket, block_row, *,
                          block_t: int = 16, block_o: int = 2048):
    """B4b: y = h_blk[:, :r_b] @ B_b[row] for every whole block (h's
    columns r_b..max_r are not read). B_banks: sequence of B_b (Na_b, r_b,
    d_out_local) sharing d_out_local, r_b <= max_r. Returns (T_pad,
    d_out_local) in h's type; on CUDA rows past the last whole block are
    left unwritten. ``block_o`` is validated and, as in ``sgmv_expand``,
    does not shape the card's grid (token blocks, ceil(d_out_local /
    EXPAND_COLS))."""
    B_banks = list(B_banks)
    refuse_autograd("sgmv_multibank_expand", h_pad, B_banks)
    if h_pad.device.type == "cpu":
        return sgmv_multibank_expand_blocks_ref(h_pad, B_banks, block_bucket,
                                                block_row, block_t=block_t)
    _check_x(h_pad, block_t)
    T_pad, max_r = h_pad.shape
    _check_n_buckets(B_banks)
    d_out = B_banks[0].shape[-1]
    for B in B_banks:
        _check_weight(h_pad, B, "B", B.shape[1], 1)
        if B.shape[1] > max_r or B.shape[-1] != d_out:
            raise ValueError(f"B {tuple(B.shape)} does not fit h "
                             f"{tuple(h_pad.shape)} and d_out {d_out}")
    if block_o < 1:
        raise ValueError(f"block_o={block_o} must be positive")
    nblocks = T_pad // block_t
    _check_index(h_pad, block_bucket, nblocks, "block_bucket")
    _check_index(h_pad, block_row, nblocks, "block_row")
    b_ptrs, ranks = _bucket_ptrs(B_banks, 1)
    out = torch.empty((T_pad, d_out), dtype=h_pad.dtype, device=h_pad.device)
    _launch("sgmv_multibank_expand_launch", h_pad.device,
            _DTYPE_CODE[h_pad.dtype], h_pad.data_ptr(), b_ptrs, ranks,
            len(B_banks), block_bucket.data_ptr(), block_row.data_ptr(),
            out.data_ptr(), nblocks, block_t, max_r, d_out)
    sgmv_multibank_expand.launches += 1
    return out


sgmv_multibank_expand.launches = 0
