"""SwiGLU feed-forward of the PyTorch port (the dense half of the JAX
package's ``models/ffn.py``; MoE waits for ROADMAP queue A item 11).

Tensor parallel (``tp``): a rank holds column slices of ``w1``/``w3``
and the matching row slice of ``w2`` (d_ff/tp of each), so its output is
a partial sum that one ``all_reduce_`` completes."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .common import all_reduce_, dense_init


class SwiGLU(nn.Module):
    """w1, w3: (d, ff); w2: (ff, d), used as ``x @ w``."""

    def __init__(self, d: int, ff: int, gen: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.w1 = nn.Parameter(dense_init(gen, (d, ff), dtype=dtype),
                               requires_grad=False)
        self.w3 = nn.Parameter(dense_init(gen, (d, ff), dtype=dtype),
                               requires_grad=False)
        self.w2 = nn.Parameter(dense_init(gen, (ff, d), fan_in=ff,
                                          dtype=dtype), requires_grad=False)

    def forward(self, x, tp=None):
        return all_reduce_((F.silu(x @ self.w1) * (x @ self.w3)) @ self.w2,
                           tp)
