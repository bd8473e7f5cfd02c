"""Wrappers of the hand-written Hopper SGMV kernels (``csrc/sgmv.cu``)
and their plain-torch versions.

* ``sgmv_fused_blocks`` (B1) replaces the JAX package's Pallas
  ``kernels/sgmv.py:sgmv_fused_blocks``: the padded bank, one fused
  shrink+expand over a segment-blocked token layout.
* ``sgmv_multibank_blocks`` (B2) replaces ``sgmv_multibank_blocks``: the
  rank-bucketed bank set in one launch, each block at its own bucket's
  rank.

On a CPU tensor a wrapper computes its plain version; on a CUDA tensor it
launches its kernel or raises. Each wrapper counts its kernel launches in
a plain integer attribute, ``launches``. The ``*_ref`` plain versions run
the same block layout with the same fp32 sums and the same cast of the
intermediate ``h`` to the input type between the two products.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load_library

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK_T = 16
MAX_RANK = 128
MAX_BUCKETS = 8


def sgmv_fused_blocks_ref(x_pad, A, B, block_adapter, *, block_t: int = 16):
    """Plain version of B1. x_pad: (T_pad, d); A: (Na, d, r);
    B: (Na, r, d_out); block_adapter: (T_pad // block_t,) int. Returns
    (T_pad, d_out); rows past the last whole block are zero."""
    T_pad, d = x_pad.shape
    nblocks = T_pad // block_t
    n = nblocks * block_t
    idx = block_adapter[:nblocks].long()
    xb = x_pad[:n].reshape(nblocks, block_t, d).float()
    h = torch.bmm(xb, A[idx].float()).to(x_pad.dtype)
    y = torch.bmm(h.float(), B[idx].float()).to(x_pad.dtype)
    out = x_pad.new_zeros((T_pad, B.shape[-1]))
    out[:n] = y.reshape(n, -1)
    return out


def sgmv_multibank_blocks_ref(x_pad, banks, block_bucket, block_row, *,
                              block_t: int = 16):
    """Plain version of B2. banks: sequence of (A_b (Na_b, d, r_b),
    B_b (Na_b, r_b, d_out)) in ascending bucket order; block_bucket /
    block_row: (T_pad // block_t,) int. Each bucket runs over every block
    (rows of other buckets clamp to row 0, as the Pallas index maps do)
    and keeps the blocks that are its own: no host sync."""
    T_pad, d = x_pad.shape
    d_out = banks[0][1].shape[-1]
    nblocks = T_pad // block_t
    n = nblocks * block_t
    bkt = block_bucket[:nblocks].long()
    row = block_row[:nblocks].long()
    xb = x_pad[:n].reshape(nblocks, block_t, d).float()
    y = torch.zeros((nblocks, block_t, d_out), dtype=torch.float32,
                    device=x_pad.device)
    for b, (A, B) in enumerate(banks):
        sel = bkt == b
        rows = torch.where(sel, row, 0)
        h = torch.bmm(xb, A[rows].float()).to(x_pad.dtype)
        y = torch.where(sel[:, None, None], torch.bmm(h.float(),
                                                      B[rows].float()), y)
    out = x_pad.new_zeros((T_pad, d_out))
    out[:n] = y.to(x_pad.dtype).reshape(n, d_out)
    return out


def _check_x(x_pad, block_t):
    if x_pad.device.type != "cuda":
        raise ValueError(f"SGMV kernels run on CUDA or CPU tensors, got "
                         f"{x_pad.device}")
    if x_pad.dtype not in _DTYPE_CODE:
        raise TypeError(f"x_pad dtype {x_pad.dtype}: the kernels take "
                        "float32 or bfloat16")
    if x_pad.dim() != 2 or not x_pad.is_contiguous():
        raise ValueError("x_pad must be a contiguous (T_pad, d) tensor")
    if not 1 <= block_t <= MAX_BLOCK_T:
        raise ValueError(f"block_t={block_t} outside 1..{MAX_BLOCK_T}")


def _check_bank(x_pad, A, B):
    d = x_pad.shape[1]
    for name, t in (("A", A), ("B", B)):
        if t.device != x_pad.device or t.dtype != x_pad.dtype:
            raise ValueError(f"{name} must be {x_pad.dtype} on "
                             f"{x_pad.device}, got {t.dtype} on {t.device}")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 3-D tensor")
    Na, d_a, r = A.shape
    if d_a != d or B.shape[0] != Na or B.shape[1] != r:
        raise ValueError(f"bank shapes A {tuple(A.shape)} / B "
                         f"{tuple(B.shape)} do not fit x_pad (*, {d})")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside 1..{MAX_RANK}")


def _check_index(x_pad, t, nblocks, name):
    if t.device != x_pad.device or t.dtype != torch.int32 \
            or t.shape != (nblocks,) or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({nblocks},) int32 "
                         f"tensor on {x_pad.device}")


def _launch(fn_name, *args):
    err = getattr(load_library(), fn_name)(*args)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")


def sgmv_fused_blocks(x_pad, A, B, block_adapter, *, block_t: int = 16):
    """B1: fused shrink+expand over a segment-blocked layout, one launch.
    Returns (T_pad, d_out); on CUDA rows past the last whole block are
    left unwritten (no caller reads them)."""
    if x_pad.device.type == "cpu":
        return sgmv_fused_blocks_ref(x_pad, A, B, block_adapter,
                                     block_t=block_t)
    _check_x(x_pad, block_t)
    _check_bank(x_pad, A, B)
    T_pad, d = x_pad.shape
    r = A.shape[-1]
    d_out = B.shape[-1]
    nblocks = T_pad // block_t
    _check_index(x_pad, block_adapter, nblocks, "block_adapter")
    out = torch.empty((T_pad, d_out), dtype=x_pad.dtype, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("sgmv_fused_blocks_launch", _DTYPE_CODE[x_pad.dtype],
                x_pad.data_ptr(), A.data_ptr(), B.data_ptr(),
                block_adapter.data_ptr(), out.data_ptr(), nblocks, block_t,
                d, r, d_out, stream)
    sgmv_fused_blocks.launches += 1
    return out


sgmv_fused_blocks.launches = 0


def sgmv_multibank_blocks(x_pad, banks, block_bucket, block_row, *,
                          block_t: int = 16):
    """B2: one launch over a whole rank-bucketed bank set. banks: sequence
    of (A_b (Na_b, d, r_b), B_b (Na_b, r_b, d_out)), at most 8 buckets.
    Returns (T_pad, d_out) like ``sgmv_fused_blocks``."""
    if x_pad.device.type == "cpu":
        return sgmv_multibank_blocks_ref(x_pad, banks, block_bucket,
                                         block_row, block_t=block_t)
    _check_x(x_pad, block_t)
    banks = [(A, B) for A, B in banks]
    if not 1 <= len(banks) <= MAX_BUCKETS:
        raise ValueError(f"{len(banks)} buckets outside 1..{MAX_BUCKETS}")
    d_out = banks[0][1].shape[-1]
    for A, B in banks:
        _check_bank(x_pad, A, B)
        if B.shape[-1] != d_out:
            raise ValueError("every bucket's B must share d_out")
    T_pad, d = x_pad.shape
    nblocks = T_pad // block_t
    _check_index(x_pad, block_bucket, nblocks, "block_bucket")
    _check_index(x_pad, block_row, nblocks, "block_row")
    nb = len(banks)
    a_ptrs = (ctypes.c_void_p * nb)(*[A.data_ptr() for A, _ in banks])
    b_ptrs = (ctypes.c_void_p * nb)(*[B.data_ptr() for _, B in banks])
    ranks = (ctypes.c_int * nb)(*[A.shape[-1] for A, _ in banks])
    out = torch.empty((T_pad, d_out), dtype=x_pad.dtype, device=x_pad.device)
    with torch.cuda.device(x_pad.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch("sgmv_multibank_blocks_launch", _DTYPE_CODE[x_pad.dtype],
                x_pad.data_ptr(), a_ptrs, b_ptrs, ranks, nb,
                block_bucket.data_ptr(), block_row.data_ptr(),
                out.data_ptr(), nblocks, block_t, d, d_out, stream)
    sgmv_multibank_blocks.launches += 1
    return out


sgmv_multibank_blocks.launches = 0
