"""The block-diagonal deployment as the program runs it:
``MPIBlockDiag([MatrixMult(A_i)])`` of f32 blocks, each rank holding its
balanced chunk of them (the program's rule), with one data vector per
right-hand side."""

from __future__ import annotations

import torch

from portbench.harness import bounds
from portbench.harness.problem import Problem, Range
from portbench.inputs import blockdiag as inputs


def build(cfg: dict, traffic: dict, seed: int, device, pmtt) -> Problem:
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    from pylops_mpi_tpu_torch.parallel.mesh import rank, world_size
    nblk, n, chunk = int(cfg["nblk"]), int(cfg["n"]), int(cfg["chunk"])
    P, r = world_size(), rank()
    if nblk % (P * chunk):
        raise ValueError(f"{nblk} blocks do not split into chunks of {chunk} "
                         f"over {P} ranks")
    per = nblk // P
    first = r * per
    mine = list(range(first // chunk, (first + per) // chunk))
    A = inputs.blocks(cfg, seed, mine, device)
    X = inputs.models(cfg, seed, int(traffic["n_rhs"]), device)
    Y = inputs.data(A, X, first)
    del X
    # the other ranks' blocks are placeholders of the right shape: the
    # operator keeps only this rank's chunk
    stand_in = torch.empty((), device=device).expand(n, n)
    ops = [MatrixMult(A[i - first]) if first <= i < first + per
           else MatrixMult(stand_in) for i in range(nblk)]
    Op = pmtt.MPIBlockDiag(ops)
    del ops, A
    rhs = []
    for j in range(Y.shape[0]):
        v = pmtt.DistributedArray(global_shape=nblk * n, dtype=Y.dtype,
                                  device=device,
                                  local_shapes=Op.local_shapes_n)
        v[:] = Y[j]
        rhs.append(v)
    if traffic["normal"]:
        ranges = [Range(Op, "normal_matvec", "portbench.normal_apply",
                        bounds.normal_apply(per, n, n))]
    else:
        ranges = [Range(Op, m, "portbench.blockdiag_apply",
                        bounds.blockdiag_apply(per, n, n))
                  for m in ("matvec", "rmatvec")]
    return Problem(op=Op, rhs=rhs, data_rows=Y,
                   model_rows=lambda x: x.array, damp=float(cfg["damp"]),
                   ranges=ranges,
                   resolved={"fused_normal": bool(Op.has_fused_normal)})
