"""Each configuration's plain reference against pylops_mpi_tpu_torch on the
CPU, at a tiny size and in f64: the operators, their adjoints and CGLS."""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu_torch as pmtt
from helpers import TINY
from portbench.inputs import blockdiag as bd_inputs
from portbench.inputs import poststack as ps_inputs
from portbench.reference import blockdiag as bd_ref
from portbench.reference import poststack as ps_ref
from portbench.reference.cgls import cgls as plain_cgls

F64 = torch.float64


def _blockdiag(cfg):
    A = bd_inputs.blocks(cfg, 5, range(cfg["nblk"] // cfg["chunk"]), "cpu",
                         dtype=F64)
    Op = pmtt.MPIBlockDiag([pmtt.ops.local.MatrixMult(a) for a in A])
    return A, Op


def _poststack(cfg):
    nx, nt0 = cfg["nx"], cfg["nt0"]
    wav = ps_inputs.wavelet(cfg)
    Op = pmtt.models.MPIPoststackLinearModelling(wav, nt0, nx, dtype=F64,
                                                 device="cpu")
    G = pmtt.MPIGradient((nx, nt0), dtype=F64)
    return pmtt.MPIStackedVStack([Op, cfg["eps_r"] * G])


def _vec(t):
    return pmtt.DistributedArray.to_dist(t, device="cpu")


def _flat(v):
    if isinstance(v, pmtt.StackedDistributedArray):
        return torch.cat([_flat(p) for p in v.distarrays])
    return v.array


def test_blockdiag_operator_matches():
    cfg = dict(TINY["blockdiag_4096x128"])
    A, Op = _blockdiag(cfg)
    fwd, adj = bd_ref.operator(A, "f64")
    x = torch.randn(2, Op.shape[1], dtype=F64)
    for k in range(2):
        assert torch.allclose(fwd(x)[k], Op.matvec(_vec(x[k])).array,
                              rtol=1e-12, atol=1e-12)
        assert torch.allclose(adj(x)[k], Op.rmatvec(_vec(x[k])).array,
                              rtol=1e-12, atol=1e-12)


def test_poststack_operator_matches():
    cfg = {**_ps_cfg(), **TINY["poststack_65536x1024"]}
    Op = _poststack(cfg)
    fwd, adj = ps_ref.operator(cfg, "f64")
    x = torch.randn(1, Op.shape[1], dtype=F64)
    assert torch.allclose(fwd(x)[0], _flat(Op.matvec(_vec(x[0]))),
                          rtol=1e-12, atol=1e-12)
    y = Op.matvec(_vec(x[0]))
    yt = _flat(y)[None]
    assert torch.allclose(adj(yt)[0], Op.rmatvec(y).array, rtol=1e-12,
                          atol=1e-12)


def _ps_cfg():
    import json
    from helpers import ROOT
    return json.loads((ROOT / "portbench/configs/poststack_65536x1024.json")
                      .read_text())


@pytest.mark.parametrize("problem", ["blockdiag", "poststack"])
def test_reference_operators_are_adjoint(problem):
    if problem == "blockdiag":
        cfg = TINY["blockdiag_4096x128"]
        A = bd_inputs.blocks(cfg, 5, range(cfg["nblk"] // cfg["chunk"]),
                             "cpu", dtype=F64)
        fwd, adj = bd_ref.operator(A, "f64")
        n_in = n_out = A.shape[0] * A.shape[1]
    else:
        cfg = {**_ps_cfg(), **TINY["poststack_65536x1024"]}
        fwd, adj = ps_ref.operator(cfg, "f64")
        n_in = cfg["nx"] * cfg["nt0"]
        n_out = 3 * n_in
    x = torch.randn(1, n_in, dtype=F64)
    y = torch.randn(1, n_out, dtype=F64)
    lhs = float((fwd(x) * y).sum())
    rhs = float((x * adj(y)).sum())
    assert lhs == pytest.approx(rhs, rel=1e-12)


@pytest.mark.parametrize("normal", [False, True])
def test_blockdiag_cgls_matches(normal):
    cfg = TINY["blockdiag_4096x128"]
    A, Op = _blockdiag(cfg)
    fwd, adj = bd_ref.operator(A, "f64")
    y = torch.randn(1, Op.shape[0], dtype=F64)
    X, C = plain_cgls(fwd, adj, y, 8, 0.0)
    x, _, iiter, _, _, cost = pmtt.cgls(Op, _vec(y[0]), niter=8, tol=0.0,
                                        normal=normal)
    assert iiter == 8
    assert torch.allclose(x.array, X[0], rtol=1e-9, atol=1e-12)
    assert torch.allclose(cost, C[0], rtol=1e-9)


def test_poststack_cgls_matches():
    cfg = {**_ps_cfg(), **TINY["poststack_65536x1024"]}
    Op = _poststack(cfg)
    m = ps_inputs.model(cfg, 3, 0, "cpu")
    d = ps_ref.data(cfg, m).reshape(-1)
    npts = d.numel()
    X, C = ps_ref.solve(cfg, 3, d[None], 10, cfg["damp"], "cpu", "f64")
    zero = pmtt.StackedDistributedArray(
        [_vec(torch.zeros(npts, dtype=F64)) for _ in range(2)])
    x, _, iiter, _, _, cost = pmtt.cgls(
        Op, pmtt.StackedDistributedArray([_vec(d), zero]), niter=10,
        damp=cfg["damp"], tol=0.0)
    assert iiter == 10
    assert torch.allclose(x.array, X[0], rtol=1e-8, atol=1e-10)
    assert torch.allclose(cost, C[0], rtol=1e-8)


def test_data_matches_the_program_forward():
    cfg = {**_ps_cfg(), **TINY["poststack_65536x1024"]}
    m = ps_inputs.model(cfg, 9, 1, "cpu")
    Op = pmtt.models.MPIPoststackLinearModelling(
        ps_inputs.wavelet(cfg), cfg["nt0"], cfg["nx"], dtype=F64,
        device="cpu")
    assert torch.allclose(ps_ref.data(cfg, m).reshape(-1),
                          Op.matvec(_vec(m.reshape(-1))).array,
                          rtol=1e-12, atol=1e-12)
    # the repository's examples/poststack.py wavelet
    w, _ = pmtt.models.ricker(np.arange(0, 0.02, 0.002), f0=25)
    assert np.allclose(ps_inputs.wavelet(cfg), w)
