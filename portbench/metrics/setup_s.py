"""Process start to the window's opening (s): loading, making the
weights, building the cluster, the kernel library and the warm-up."""


def read(ctx):
    return ctx.setup_s
