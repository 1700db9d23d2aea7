"""The post-stack deployment as the program runs it: the
Gradient-regularized system ``[MPIPoststackLinearModelling; ε·MPIGradient]``
as an ``MPIStackedVStack`` in f32, with data ``[d; 0]`` for each
right-hand side, each rank holding its traces (the program's split)."""

from __future__ import annotations

import torch

from portbench.harness import bounds
from portbench.harness.problem import Problem, Range
from portbench.inputs import poststack as inputs
from portbench.reference import poststack as plain


def build(cfg: dict, traffic: dict, seed: int, device, pmtt) -> Problem:
    nx, nt0 = int(cfg["nx"]), int(cfg["nt0"])
    f32 = torch.float32
    wav = inputs.wavelet(cfg)
    Op = pmtt.models.MPIPoststackLinearModelling(wav, nt0, nx, dtype=f32,
                                                 device=device)
    G = pmtt.MPIGradient((nx, nt0), dtype=f32)
    StackOp = pmtt.MPIStackedVStack([Op, float(cfg["eps_r"]) * G])
    rows = [s[0] for s in Op.local_shapes_n]
    me = pmtt.parallel.mesh.rank()
    lo = sum(rows[:me])
    Y = torch.empty((int(traffic["n_rhs"]), rows[me]), dtype=f32,
                    device=device)
    for j in range(Y.shape[0]):
        d = plain.data(cfg, inputs.model(cfg, seed, j, device))
        Y[j] = d.reshape(-1)[lo:lo + rows[me]]
        del d

    def vector(local_shapes, value=None):
        v = pmtt.DistributedArray(global_shape=nx * nt0, dtype=f32,
                                  device=device, local_shapes=local_shapes)
        if value is not None:
            v[:] = value
        return v
    zero = pmtt.StackedDistributedArray(
        [vector(G.local_shapes_m) for _ in range(2)])
    rhs = [pmtt.StackedDistributedArray([vector(Op.local_shapes_n, Y[j]),
                                         zero])
           for j in range(Y.shape[0])]
    ranges = [Range(StackOp, m, "portbench.poststack_apply",
                    bounds.poststack_apply(rows[me]))
              for m in ("matvec", "rmatvec")]
    return Problem(op=StackOp, rhs=rhs, data_rows=Y,
                   model_rows=lambda x: x.array, damp=float(cfg["damp"]),
                   ranges=ranges)
