"""Summed host self time of the LoRA part (the hooks ``make_lora_cb``
returns, and their binding per layer) on the window's ``decode.launch``
spans over the same steps (ms a step)."""
from portbench.hostspans import lora_host_ms


def read(ctx):
    return lora_host_ms(ctx)
