"""Faults planted under the timed path, for the test that shows a broken
program reads as not correct. A run takes one when ``PORTBENCH_FAULT`` names
it (the test sets it; the benchmark's own runs never do).

- ``frozen_step``: each CGLS iteration returns its state unchanged;
- ``half_batch``: every operator apply leaves out the second half of the
  rows of its output;
- ``altered_answer``: one entry of each solution is changed where the
  solver returns it.
"""

from __future__ import annotations

import os

FAULTS = ("frozen_step", "half_batch", "altered_answer")
ENV = "PORTBENCH_FAULT"


def armed() -> str:
    name = os.environ.get(ENV, "")
    if name and name not in FAULTS:
        raise ValueError(f"{ENV}={name!r}: one of {FAULTS}")
    return name


def _halve(v):
    from pylops_mpi_tpu_torch import StackedDistributedArray
    if isinstance(v, tuple):
        return tuple(_halve(p) for p in v)
    if isinstance(v, StackedDistributedArray):
        for p in v.distarrays:
            _halve(p)
        return v
    arr = v.array
    arr[arr.shape[0] // 2:] = 0
    return v


def plant(name: str, pmtt, problem) -> None:
    """Break the program ``pmtt`` (or the problem's operator) as ``name``
    says."""
    if name == "frozen_step":
        from pylops_mpi_tpu_torch.solvers import basic

        def frozen(*args, **kwargs):
            return lambda state, consts: state
        basic._cgls_step = frozen
    elif name == "half_batch":
        for method in ("matvec", "rmatvec", "normal_matvec"):
            orig = getattr(problem.op, method)

            def broken(x, _orig=orig):
                return _halve(_orig(x))
            setattr(problem.op, method, broken)
    elif name == "altered_answer":
        orig = pmtt.cgls

        def altered(*args, **kwargs):
            out = orig(*args, **kwargs)
            arr = out[0].array
            i = arr.shape[0] // 2
            arr[i] += 1e-2 * arr.abs().max()
            return out
        pmtt.cgls = altered
