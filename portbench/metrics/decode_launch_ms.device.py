"""Summed host time of the decode blocks' launches (``decode.launch``:
the block's start to just before its one sync) over the decode steps of
the window's ``decode`` spans (ms a step)."""
from portbench.hostspans import decode_launch_ms


def read(ctx):
    return decode_launch_ms(ctx)
