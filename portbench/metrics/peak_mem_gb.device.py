"""torch.cuda.max_memory_allocated over the window, after a reset at its
opening (GB)."""


def read(ctx):
    return ctx.peak_window_bytes / 1e9 if ctx.peak_window_bytes else None
