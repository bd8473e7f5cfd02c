"""SGMV LoRA kernels of the PyTorch port: hand-written CUDA for Hopper
(``csrc/sgmv.cu``, built at first use by ``build.py``), with plain-torch
versions that the wrappers use for CPU tensors."""
from .ops import (padded_len, prepare_segments, prepare_segments_bucketed,
                  sgmv_bucketed_fused, sgmv_fused, sgmv_reference)
from .ref import sgmv_expand_ref, sgmv_ref, sgmv_shrink_ref
from .sgmv import (sgmv_fused_blocks, sgmv_fused_blocks_ref,
                   sgmv_multibank_blocks, sgmv_multibank_blocks_ref)

__all__ = ["padded_len", "prepare_segments", "prepare_segments_bucketed",
           "sgmv_fused", "sgmv_bucketed_fused", "sgmv_reference",
           "sgmv_ref", "sgmv_shrink_ref", "sgmv_expand_ref",
           "sgmv_fused_blocks", "sgmv_fused_blocks_ref",
           "sgmv_multibank_blocks", "sgmv_multibank_blocks_ref"]
