"""The model FLOPs the window's tokens need over the window at the
card's bf16 dense peak (%): see readers.window_flops."""
from portbench.readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
