"""Summed decode iteration span time over the decode steps it ran (ms a
step)."""
from portbench.readers import decode_step_ms


def read(ctx):
    return decode_step_ms(ctx)
