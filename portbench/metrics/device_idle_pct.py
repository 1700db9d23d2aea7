"""The share of the profiled solves' span in which no operation ran on the
device (torch.profiler's kernels, copies and fills)."""


def read(ctx):
    t = ctx.trace
    if not t or t["span_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
