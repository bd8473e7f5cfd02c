"""Share of the traced slice of the window in which no device operation
ran (%)."""
from portbench.readers import idle_share


def read(ctx):
    return idle_share(ctx)
