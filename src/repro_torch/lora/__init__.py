"""LoRA adapters, banks and batched application of the PyTorch port."""
from .adapter import (Adapter, adapter_key, bank_nbytes, init_adapter,
                      init_bank_from, pad_rank)
from .bank import LoRABank, build_bank, rank_bucket
from .batched import (apply_bank_sgmv, lora_delta, lora_delta_bucketed,
                      make_lora_cb)

__all__ = ["Adapter", "adapter_key", "bank_nbytes", "init_adapter",
           "init_bank_from", "pad_rank", "LoRABank", "build_bank",
           "rank_bucket", "lora_delta", "lora_delta_bucketed",
           "make_lora_cb", "apply_bank_sgmv"]
