"""The cluster facade's own host time in the window, its ``poll`` spans
less the engine's spans inside them, over the window (%)."""
from portbench.hostspans import facade_share


def read(ctx):
    return facade_share(ctx)
