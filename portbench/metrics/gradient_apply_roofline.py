"""One forward or adjoint apply of the regularizer's ``MPIGradient``: the
byte bound (the model read once, its two components written once, or the
reverse) over the device time launched inside the program's
``MPIGradient.matvec`` and ``.rmatvec`` spans, pooled over the calls, in
% (the program's spans traced apart, :mod:`portbench.harness.spans`)."""

from portbench.harness import spans


def read(ctx):
    npoints = ctx.record["data_rows"].shape[1]
    return spans.roofline_pct(
        ctx, ("MPIGradient.matvec", "MPIGradient.rmatvec"),
        spans.gradient_apply(npoints))
