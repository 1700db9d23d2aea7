"""Device time launched by the solver's loop itself (its
``solver.segment`` spans innermost: the vector updates, reductions and
scalar steps, not the operator's applies) over the profiled iterations,
in ms (the program's spans traced apart, :mod:`portbench.harness.spans`)."""

from portbench.harness import spans


def read(ctx):
    st = spans.span(ctx, "solver.segment")
    if not st or st["self_device_s"] <= 0.0:
        return None
    iters = spans.summary(ctx)["traced_iters"]
    return 1e3 * st["self_device_s"] / iters if iters > 0 else None
