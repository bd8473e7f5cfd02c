"""Block size of the rank-bucketed SGMV dispatch, the counterpart of the
JAX package's ``kernels/tune.py:block_plan`` (its ``block_t`` only).

The rank-bucketed path lays every adapter's tokens out in whole blocks of
``block_t`` rows, and kernel B2 runs one thread-block cluster per block.
Small blocks waste fewer padding rows per adapter; large blocks read an
adapter's A and B fewer times per token. The JAX package settles that
trade per bank signature with a small table keyed by each bucket's
expected token share, its rank and the model width, collapsed to one
``block_t`` by a vote weighted by expected tokens. The table is a rule
about padding waste against per-block overhead, not a TPU constant, so
the port keeps it as it is: the same signature gives the same ``block_t``
in both packages, and the engine's bucketed layouts (``dest``, the block
buckets and rows, ``T_pad``) equal the reference's.

Left out: the TPU plan's bank residency (``resident``) and its VMEM
budget. On the H100 a thread block's shared memory and registers bound
the kernel, and B2 reads each block's weights once whatever the bank's
size, so neither has a counterpart.

``block_plan`` refuses a ``block_t`` that B2's CUDA kernel does not take
(``SUPPORTED_BLOCK_T``: 1..16, 32 and 64). Import-light: the standard
library only, nothing of the JAX package.
"""
from __future__ import annotations

import functools
from typing import Tuple

# the block sizes kernel B2 takes: one 16-row tile, or 2 or 4 of them
SUPPORTED_BLOCK_T = frozenset(range(1, 17)) | {32, 64}

# (T_b band, r_b band, d band) -> preferred block_t for that bucket.
# Bands: T_b <= 128 | <= 1024 | larger; r_b <= 32 | larger; d <= 4096 |
# larger. Small buckets want small blocks (an adapter wastes < block_t
# rows, and a high-rank block's padding rows run high-rank products);
# large low-rank buckets spread the per-block cost over 64 rows; wide
# models take smaller blocks.
_BLOCK_T_TABLE = {
    ("small", "low", "narrow"): 16,
    ("small", "high", "narrow"): 16,
    ("mid", "low", "narrow"): 64,
    ("mid", "high", "narrow"): 32,
    ("large", "low", "narrow"): 64,
    ("large", "high", "narrow"): 64,
    ("small", "low", "wide"): 16,
    ("small", "high", "wide"): 16,
    ("mid", "low", "wide"): 32,
    ("mid", "high", "wide"): 32,
    ("large", "low", "wide"): 32,
    ("large", "high", "wide"): 32,
}


def _t_band(t_b: int) -> str:
    if t_b <= 128:
        return "small"
    if t_b <= 1024:
        return "mid"
    return "large"


def _r_band(r_b: int) -> str:
    return "low" if r_b <= 32 else "high"


def _d_band(d: int) -> str:
    return "narrow" if d <= 4096 else "wide"


def bucket_block_t(t_b: int, r_b: int, d: int) -> int:
    """Preferred block_t for one bucket of ~t_b tokens at rank r_b."""
    return _BLOCK_T_TABLE[(_t_band(t_b), _r_band(r_b), _d_band(d))]


def check_block_t(block_t: int) -> int:
    """``block_t`` if kernel B2 takes it, else ValueError."""
    if block_t not in SUPPORTED_BLOCK_T:
        raise ValueError(f"block_t={block_t}: kernel B2 takes 1..16, 32 "
                         "and 64")
    return block_t


@functools.lru_cache(maxsize=256)
def block_plan(T: int, d: int, d_out: int, ranks: Tuple[int, ...],
               counts: Tuple[int, ...]) -> int:
    """``block_t`` of a rank-bucketed dispatch: T tokens in the batch,
    d / d_out the widths the kernel sees, ranks / counts each bucket's
    (r_b, adapters) in ascending bucket order. Cached per bank signature.
    ``d_out`` shapes nothing here (the TPU plan used it for residency);
    it stays in the signature so that both packages' plans key alike."""
    del d_out
    n_total = max(1, sum(counts))
    # token share estimate per bucket (counts are all that is static)
    t_est = [max(1, T * n_b // n_total) for n_b in counts]
    votes = {}
    for t_b, r_b in zip(t_est, ranks):
        bt = bucket_block_t(t_b, r_b, d)
        votes[bt] = votes.get(bt, 0) + t_b
    block_t = max(sorted(votes), key=lambda bt: votes[bt])
    # a block_t above the largest plausible segment only adds padding
    while block_t > 16 and block_t > max(t_est):
        block_t //= 2
    return check_block_t(block_t)
