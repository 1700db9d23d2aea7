"""One normal product's byte bound (A read once, x read, u and q written,
at the card's memory rate) over the device time of the kernels launched
inside the benchmark's range around the operator's ``normal_matvec``,
pooled over the calls, in %."""


def read(ctx):
    return ctx.roofline_pct("portbench.normal_apply")
