"""Every output token the engine emitted inside the window, over the
window (tokens/s), in the cells whose pace the host sets (one host
thread launching every kernel), where runs spread as the host's speed
does."""


def read(ctx):
    return sum(r.out_close - r.out_open for r in ctx.records) / ctx.window_s
