"""Share of the traced slice in which no device operation ran and the
host was inside a ``decode.launch`` or ``prefill.launch`` span, the
device's times mapped onto the cluster clock by the ``clock`` snapshots
(%); never above ``device_idle_share``."""
from portbench.hostspans import launch_idle_share


def read(ctx):
    return launch_idle_share(ctx)
