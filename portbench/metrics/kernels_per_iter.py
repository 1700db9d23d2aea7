"""Device kernels launched in the profiled solves over their iterations."""


def read(ctx):
    t = ctx.trace
    if not t or t["kernels"] <= 0 or ctx.traced_iters <= 0:
        return None
    return t["kernels"] / ctx.traced_iters
