"""The 95th percentile of the wall time of every solve of the window, from
its call until its x is on the device (host clock)."""


def read(ctx):
    return 1e3 * ctx.quantile(ctx.times, 0.95) if ctx.times else None
