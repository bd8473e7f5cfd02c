"""Plain-torch oracle for the SGMV (segmented gather matrix-multiply)
kernels, the counterpart of the JAX package's ``kernels/ref.py``.

Every token gathers the A/B matrices of *its* adapter from a bank padded
to the bank-wide max rank, so low-rank adapters pay max-rank compute (the
padding tax the paper analyzes).
"""
from __future__ import annotations

import torch


def sgmv_ref(x, A, B, token_adapter, scaling: float = 1.0):
    """x: (T, d_in); A: (Na, d_in, r); B: (Na, r, d_out);
    token_adapter: (T,) int. Returns (T, d_out)."""
    idx = token_adapter.long()
    h = torch.einsum("td,tdr->tr", x, A[idx].to(x.dtype))
    y = torch.einsum("tr,tro->to", h, B[idx].to(x.dtype))
    return y * scaling


def sgmv_shrink_ref(x, A, token_adapter):
    return torch.einsum("td,tdr->tr", x, A[token_adapter.long()].to(x.dtype))


def sgmv_expand_ref(h, B, token_adapter, scaling: float = 1.0):
    b = B[token_adapter.long()].to(h.dtype)
    return torch.einsum("tr,tro->to", h, b) * scaling
