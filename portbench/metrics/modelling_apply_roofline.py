"""One forward or adjoint apply of the post-stack modelling operator
``0.5·W·D``: the byte bound (the model read once, the data written once,
or the reverse) over the device time launched inside the program's spans
of that operator's ``matvec`` and ``rmatvec``, pooled over the calls, in
% (the program's spans traced apart, :mod:`portbench.harness.spans`).
``MPIPoststackLinearModelling`` builds an ``MPIBlockDiag`` of one
``0.5·W·D`` a rank, the cell's only one, so the spans carry that name."""

from portbench.harness import spans


def read(ctx):
    npoints = ctx.record["data_rows"].shape[1]
    return spans.roofline_pct(
        ctx, ("MPIBlockDiag.matvec", "MPIBlockDiag.rmatvec"),
        spans.modelling_apply(npoints))
