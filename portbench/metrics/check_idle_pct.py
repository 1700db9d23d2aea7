"""The idle gaps of the profiled solves' span that began while the host
was reading the device in the program's loop control (its ``solver.check``
and ``solver.readback`` spans innermost: the host check of the loop
condition and the final read-back), over that span, in % (the program's
spans traced apart, :mod:`portbench.harness.spans`)."""

from portbench.harness import spans


def read(ctx):
    st = spans.span(ctx, "solver.check", "solver.readback")
    if not st:
        return None
    return 100.0 * st["idle_s"] / spans.summary(ctx)["span_s"]
