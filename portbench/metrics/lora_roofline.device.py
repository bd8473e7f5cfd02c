"""The least time of the traced iterations' LoRA work over the device
time of the SGMV kernels that did it (%)."""
from portbench.readers import lora_roofline

KERNELS = ("sgmv",)


def read(ctx):
    return lora_roofline(ctx, KERNELS)
