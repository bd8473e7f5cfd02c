"""LoRA adapters, banks and batched application of the PyTorch port."""
from .adapter import (Adapter, adapter_key, bank_layers, bank_nbytes,
                      init_adapter, init_bank_from, merge_adapter,
                      pad_adapter)
from .bank import LoRABank, build_bank, rank_bucket
from .batched import (apply_bank_sgmv, lora_delta, lora_delta_bucketed,
                      make_lora_cb)

__all__ = ["Adapter", "adapter_key", "bank_layers", "bank_nbytes",
           "init_adapter", "init_bank_from", "merge_adapter", "pad_adapter", "LoRABank", "build_bank",
           "rank_bucket", "lora_delta", "lora_delta_bucketed",
           "make_lora_cb", "apply_bank_sgmv"]
