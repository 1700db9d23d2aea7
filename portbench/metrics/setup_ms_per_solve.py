"""Device time launched inside the program's ``solver.setup`` spans (the
fused solve's first residual, gradient and carry, operator applies
included) over their calls, in ms a solve (the program's spans traced
apart, :mod:`portbench.harness.spans`)."""

from portbench.harness import spans


def read(ctx):
    st = spans.span(ctx, "solver.setup")
    if not st or st["device_s"] <= 0.0:
        return None
    return 1e3 * st["device_s"] / st["calls"]
