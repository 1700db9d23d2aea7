"""Process start to the window's start: imports, CUDA's start, the kernels
loaded, the inputs made and the warm-up solve (host clock)."""


def read(ctx):
    return ctx.setup_s
