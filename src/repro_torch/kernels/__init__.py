"""Kernels of the PyTorch port: hand-written CUDA for Hopper (``csrc/``,
built at first use by ``build.py``) — the SGMV LoRA kernels B1, B2, B3a,
B3b, B4a, B4b (``sgmv.py``) and the flash-attention kernel B5
(``flash.py``) — with plain-torch versions that the wrappers use for CPU
tensors. The unfused ``ops.sgmv`` is not re-exported here:
``repro_torch.kernels.sgmv`` names the kernel module."""
from .flash import flash_mha, flash_mha_plain
from .ops import (bgmv, padded_len, prepare_segments,
                  prepare_segments_bucketed, sgmv_bucketed_fused,
                  sgmv_fused, sgmv_rank_bucketed, sgmv_reference)
from .ref import sgmv_expand_ref, sgmv_ref, sgmv_shrink_ref
from .sgmv import (sgmv_expand, sgmv_expand_blocks_ref, sgmv_fused_blocks,
                   sgmv_fused_blocks_ref, sgmv_multibank_blocks,
                   sgmv_multibank_blocks_ref, sgmv_multibank_expand,
                   sgmv_multibank_expand_blocks_ref, sgmv_multibank_shrink,
                   sgmv_multibank_shrink_blocks_ref, sgmv_shrink,
                   sgmv_shrink_blocks_ref)

__all__ = ["flash_mha", "flash_mha_plain",
           "padded_len", "prepare_segments", "prepare_segments_bucketed",
           "bgmv", "sgmv_rank_bucketed",
           "sgmv_fused", "sgmv_bucketed_fused", "sgmv_reference",
           "sgmv_ref", "sgmv_shrink_ref", "sgmv_expand_ref",
           "sgmv_fused_blocks", "sgmv_fused_blocks_ref",
           "sgmv_multibank_blocks", "sgmv_multibank_blocks_ref",
           "sgmv_shrink", "sgmv_shrink_blocks_ref",
           "sgmv_expand", "sgmv_expand_blocks_ref",
           "sgmv_multibank_shrink", "sgmv_multibank_shrink_blocks_ref",
           "sgmv_multibank_expand", "sgmv_multibank_expand_blocks_ref"]
