"""CGLS iterations of the solves completed in the window over the time
from the window's start to the end of its last solve (host clock)."""


def read(ctx):
    return ctx.iterations / ctx.window_s if ctx.window_s > 0 else None
