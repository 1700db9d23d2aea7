"""One forward or adjoint apply of ``[W·D; ε·∇]``: the byte bound (the
model read once, the three outputs written once, or the reverse) over the
device time of the kernels launched inside the benchmark's ranges around
the stacked operator's ``matvec`` and ``rmatvec``, pooled over the calls,
in %."""


def read(ctx):
    return ctx.roofline_pct("portbench.poststack_apply")
