"""The port's solvers across ranks, end to end, held against the JAX
package on a mesh of the same size: CGLS (classic and ``normal=True``)
and CG on ``MPIBlockDiag``, a masked CGLS whose groups solve apart, the
class path's printing on rank 0, and the post-stack paths
(Gradient-regularized CGLS and the Laplacian ``poststack_inversion``).
Gloo worlds of 1 to 4 ranks are spawned as in
``test_torch_process_group.py``; the rank-side functions import no JAX.

Also, with no process group, the functional ``cg``/``cgls`` argument
order of the JAX package: the positional ``show``, ``callback`` once per
iteration, ``guards=`` raising on a communication-avoiding engine and
``M=`` refusing the class path.

Tolerance: rtol 1e-9 (relative to the largest entry of the reference)
for 10 CGLS/CG iterations in f64.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from test_torch_process_group import (WORLDS, close, jax_mesh, mask_of,
                                      run_world)

NITER = 10
RTOL = 1e-9


def _blocks(rng, nblk, m, n, symmetric=False):
    out = []
    for _ in range(nblk):
        b = rng.standard_normal((m, n)) / np.sqrt(n)
        if symmetric:
            b = 0.5 * (b + b.T)
        b[np.arange(min(m, n)), np.arange(min(m, n))] += 4.0
        out.append(b)
    return out


# ------------------------------------------------------- CGLS and CG

def _solvers_rank(blocks, sym, y, ysym, x0, mask):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.parallel import collectives as co
    Op = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    dy = D.to_dist(y, local_shapes=Op.local_shapes_n, device="cpu")
    dx0 = D.to_dist(x0, local_shapes=Op.local_shapes_m, device="cpu")
    out = {}
    for normal in (False, True):
        for damp, start in ((0.0, None), (0.3, dx0)):
            co.reset_counts()
            x, istop, iiter, r1, r2, cost = pmtt.cgls(
                Op, dy, start, NITER, damp, 0.0, normal=normal)
            calls = co.counts["all_reduce"] / NITER
            out[(normal, damp)] = (x.array.numpy(), iiter, float(r1),
                                   float(r2), cost.numpy(), calls,
                                   x.asarray())
    S = pmtt.convert.blockdiag_from_numpy(sym, device="cpu")
    x, iiter, cost = pmtt.cg(S, D.to_dist(ysym, local_shapes=S.local_shapes_n,
                                          device="cpu"), niter=NITER, tol=0.0)
    out["cg"] = (x.asarray(), iiter, cost.numpy())
    # the class path: the same iterations, printed on rank 0 only
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        xc, _, ic, _, _, cc = pmtt.cgls(Op, dy, None, NITER, 0.0, 0.0, True)
    out["class"] = (xc.asarray(), ic, cc, buf.getvalue())
    # a masked solve: each group of ranks runs its own recurrence
    mats = [pmtt.ops.local.MatrixMult(torch.from_numpy(b)) for b in blocks]
    Om = pmtt.MPIBlockDiag(mats, mask=mask)
    ym = D.to_dist(y, local_shapes=Om.local_shapes_n, mask=mask,
                   device="cpu")
    xm = pmtt.cgls(Om, ym, niter=NITER, tol=0.0, normal=True)[0]
    out["masked"] = (xm.array.numpy(), xm.mask, xm.asarray())
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_cgls_cg(n, tmp_path, rng):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.ops.local import MatrixMult as JM
    blocks = _blocks(rng, 10, 16, 12)
    sym = _blocks(rng, 10, 12, 12, symmetric=True)
    y = rng.standard_normal(160)
    ysym = rng.standard_normal(120)
    x0 = rng.standard_normal(120)
    mask = mask_of(n)

    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        jop = pmt.MPIBlockDiag([JM(b) for b in blocks], mesh=mesh)
        jy = J.to_dist(y, mesh=mesh, local_shapes=jop.local_shapes_n)
        jx0 = J.to_dist(x0, mesh=mesh, local_shapes=jop.local_shapes_m)
        out = {}
        for normal in (False, True):
            for damp, start in ((0.0, None), (0.3, jx0)):
                x, istop, iiter, r1, r2, cost = pmt.cgls(
                    jop, jy, start, NITER, damp, 0.0, normal=normal)
                out[(normal, damp)] = (x.local_arrays(), iiter, float(r1),
                                       float(r2), np.asarray(cost),
                                       x.asarray())
        S = pmt.MPIBlockDiag([JM(b) for b in sym], mesh=mesh)
        x, iiter, cost = pmt.cg(S, J.to_dist(ysym, mesh=mesh,
                                             local_shapes=S.local_shapes_n),
                                niter=NITER, tol=0.0)
        out["cg"] = (x.asarray(), iiter, np.asarray(cost))
        jm = pmt.MPIBlockDiag([JM(b) for b in blocks], mask=mask, mesh=mesh)
        xm = pmt.cgls(jm, J.to_dist(y, mesh=mesh, mask=mask,
                                    local_shapes=jm.local_shapes_n),
                      J.to_dist(np.zeros(120), mesh=mesh, mask=mask,
                                local_shapes=jm.local_shapes_m),
                      niter=NITER, tol=0.0, normal=True)[0]
        out["masked"] = (xm.local_arrays(), xm.asarray())
        return out

    res, ref = run_world(_solvers_rank, n, tmp_path, blocks, sym, y, ysym,
                         x0, mask, during=reference)
    for r, o in enumerate(res):
        for key in [(False, 0.0), (False, 0.3), (True, 0.0), (True, 0.3)]:
            x, iiter, r1, r2, cost, per_iter, xg = o[key]
            jx, jiiter, jr1, jr2, jcost, jxg = ref[key]
            assert iiter == jiiter == NITER
            close(xg, jxg, RTOL)
            if key[1]:  # from x0 the JAX package keeps the blocks' split
                close(x, jx[r], RTOL)
            close(r1, jr1, RTOL)
            close(r2, jr2, RTOL)
            close(cost, jcost, RTOL)
            # one all_reduce per dot or norm: 3 an iteration (q·q, r·r,
            # |s|), 5 with damping (c·c and x·x too), and 2 or 3 at setup
            damped = key[1] != 0.0
            assert per_iter == (5 if damped else 3) + (3 if damped else 2) \
                / NITER
        x, iiter, cost = o["cg"]
        jx, jiiter, jcost = ref["cg"]
        assert iiter == jiiter == NITER
        close(x, jx, RTOL)
        close(cost, jcost, RTOL)
        xc, ic, cc, printed = o["class"]
        _, _, _, _, jcost, jxg = ref[(False, 0.0)]
        assert ic == NITER
        close(xc, jxg, RTOL)
        close(cc, jcost, RTOL)
        lines = printed.splitlines()
        assert (lines[:1] == ["CGLS"] and len(lines) == NITER + 2) \
            if r == 0 else printed == ""
        xm, mk, xmg = o["masked"]
        jxm, jxmg = ref["masked"]
        assert mk == tuple(mask)
        close(xm, jxm[r], RTOL)
        # the gather of a masked array spans the world, as in the JAX package
        close(xmg, jxmg, RTOL)


# ---------------------------------------------------------- post-stack

NX, NT0 = 13, 32


def _poststack_rank(wav, m, d, eps):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.models import poststack as tp
    from pylops_mpi_tpu_torch.ops import derivatives
    Op = tp.MPIPoststackLinearModelling(wav, NT0, NX, device="cpu")
    G = pmtt.MPIGradient((NX, NT0))
    S = pmtt.MPIStackedVStack([Op, eps * G])
    lay = G.local_shapes_m
    y = pmtt.StackedDistributedArray([
        D.to_dist(d.ravel(), local_shapes=Op.local_shapes_n, device="cpu"),
        pmtt.StackedDistributedArray([
            D(global_shape=NX * NT0, local_shapes=lay, device="cpu",
              dtype=torch.float64) for _ in range(2)])])
    derivatives.paths.clear()
    x, istop, iiter, r1, r2, cost = pmtt.cgls(S, y, niter=NITER, damp=1e-4,
                                              tol=0.0)
    out = dict(held=len(Op.ops), lsm=Op.local_shapes_m, glay=lay,
               grad=(x.array.numpy(), iiter, cost.numpy(),
                     dict(derivatives.paths)))
    derivatives.paths.clear()
    xi, _ = tp.poststack_inversion(d, wav, niter=NITER, epsR=1e-2,
                                   damp=1e-3, device="cpu")
    out["lap"] = (xi, dict(derivatives.paths))
    return out


@pytest.mark.parametrize("n", WORLDS)
def test_poststack(n, tmp_path, monkeypatch):
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu.models import poststack as jp
    from pylops_mpi_tpu_torch.models import poststack as tp
    rng = np.random.default_rng(7)
    wav, _ = jp.ricker(np.arange(0, 0.02, 0.002), f0=25)
    m = np.cumsum(rng.standard_normal((NX, NT0)) * 0.03, axis=1) + 2.0
    eps = 0.1
    monkeypatch.setenv("PYLOPS_MPI_TPU_EXPLICIT_STENCIL", "0")

    # the data, modelled here by the port with no group (the JAX
    # package's modelling agrees to 1e-12, test_torch_poststack.py)
    d = tp.MPIPoststackLinearModelling(wav, NT0, NX, device="cpu").matvec(
        pmtt.DistributedArray.to_dist(m.ravel(), device="cpu")).asarray()

    def reference():
        mesh = jax_mesh(n)
        J = pmt.DistributedArray
        jOp = jp.MPIPoststackLinearModelling(wav, NT0, NX, mesh=mesh)
        jG = pmt.MPIGradient((NX, NT0), mesh=mesh)
        jS = pmt.MPIStackedVStack([jOp, eps * jG])
        jx0 = J.to_dist(np.zeros(NX * NT0), mesh=mesh,
                        local_shapes=jOp.local_shapes_m)
        jy = pmt.StackedDistributedArray([
            J.to_dist(d, mesh=mesh, local_shapes=jOp.local_shapes_n),
            jG.matvec(jx0)])
        x, istop, iiter, r1, r2, cost = pmt.cgls(jS, jy, jx0, niter=NITER,
                                                 damp=1e-4, tol=0.0)
        xi, _ = jp.poststack_inversion(d.reshape(NX, NT0), wav, niter=NITER,
                                       epsR=1e-2, damp=1e-3, mesh=mesh)
        return (jOp.local_shapes_m, x.local_arrays(), iiter,
                np.asarray(cost), xi)

    res, ref = run_world(_poststack_rank, n, tmp_path, wav, m,
                         d.reshape(NX, NT0), eps, during=reference)
    jlsm, jx, jiiter, jcost, jxi = ref
    rows = [len(c) for c in np.array_split(np.arange(NX), n)]
    for r, o in enumerate(res):
        assert o["held"] == 1 and o["lsm"] == jlsm
        assert o["glay"] == tuple((k * NT0,) for k in rows)
        x, iiter, cost, paths = o["grad"]
        assert iiter == jiiter == NITER
        close(x, jx[r], RTOL)
        close(cost, jcost, RTOL)
        # every Gradient apply ran its axis 0 on the exchange (the tap
        # kernel's path) and its axis 1 on the shard: two matvecs and a
        # rmatvec in the setup, a matvec and a rmatvec an iteration
        napply = 2 * NITER + 3
        assert paths == {"explicit": napply, "local": napply}
        xi, lpaths = o["lap"]
        close(xi, jxi, RTOL)
        assert lpaths == ({"local": napply} if n == 1
                          else {"explicit": napply, "local": napply})


# ------------------------------------------- the cg/cgls argument order

def _systems(rng):
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu.ops.local import MatrixMult as JM
    blocks = _blocks(rng, 4, 12, 12, symmetric=True)
    y = rng.standard_normal(48)
    jop = pmt.MPIBlockDiag([JM(b) for b in blocks])
    top = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    return (jop, pmt.DistributedArray.to_dist(y),
            top, pmtt.DistributedArray.to_dist(y, device="cpu"))


def test_cgls_positional_show(rng, capsys, monkeypatch):
    """``cgls(Op, y, None, 5, 0.0, 1e-4, True)`` binds ``True`` to
    ``show`` (the class path, printing), not to ``normal``."""
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    jop, jy, top, ty = _systems(rng)
    calls = []
    monkeypatch.setattr(type(top), "normal_matvec",
                        lambda self, x: calls.append(1))
    jout = pmt.cgls(jop, jy, None, 5, 0.0, 1e-4, True)
    jprinted = capsys.readouterr().out
    tout = pmtt.cgls(top, ty, None, 5, 0.0, 1e-4, True)
    tprinted = capsys.readouterr().out
    assert not calls
    assert tout[1:3] == jout[1:3]
    close(tout[0].asarray(), jout[0].asarray(), RTOL)
    close(tout[3], jout[3], RTOL)
    close(tout[4], jout[4], RTOL)
    assert isinstance(tout[5], np.ndarray)
    close(tout[5], jout[5], RTOL)
    assert tprinted.splitlines()[0] == jprinted.splitlines()[0] == "CGLS"
    assert len(tprinted.splitlines()) == len(jprinted.splitlines()) \
        == tout[2] + 2
    # the same for cg: cg(Op, y, x0, niter, tol, show)
    jx, ji, jc = pmt.cg(jop, jy, None, 5, 1e-4, True)
    tx, ti, tc = pmtt.cg(top, ty, None, 5, 1e-4, True)
    assert ti == ji and capsys.readouterr().out.count("CG\n") == 2
    close(tx.asarray(), jx.asarray(), RTOL)
    close(tc, jc, RTOL)


@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_callback_once_per_iteration(rng, solver):
    import pylops_mpi_tpu as pmt
    import pylops_mpi_tpu_torch as pmtt
    jop, jy, top, ty = _systems(rng)
    seen = {"jax": [], "torch": []}
    jout = getattr(pmt, solver)(jop, jy, niter=6, tol=0.0,
                                callback=lambda x: seen["jax"].append(
                                    np.asarray(x.asarray())))
    tout = getattr(pmtt, solver)(top, ty, niter=6, tol=0.0,
                                 callback=lambda x: seen["torch"].append(
                                     x.asarray()))
    assert len(seen["torch"]) == len(seen["jax"]) == 6
    for a, b in zip(seen["torch"], seen["jax"]):
        close(a, b, RTOL)
    close(tout[0].asarray(), jout[0].asarray(), RTOL)


@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_guards_and_m_raise(rng, solver):
    import pylops_mpi_tpu_torch as pmtt
    _, _, top, ty = _systems(rng)
    fn = getattr(pmtt, solver)
    # guards are ported, but not on the communication-avoiding engines
    os.environ["PYLOPS_MPI_TPU_TORCH_CA"] = "pipelined"
    try:
        with pytest.raises(NotImplementedError, match="§A.7"):
            fn(top, ty, niter=2, guards=True)
    finally:
        os.environ.pop("PYLOPS_MPI_TPU_TORCH_CA")
    # M= is the preconditioner seam now: the fused loop only
    with pytest.raises(ValueError, match="fused"):
        fn(top, ty, niter=2, show=True, M=top)
    with pytest.raises(ValueError, match="fused=True"):
        fn(top, ty, niter=2, show=True, fused=True)
    if solver == "cgls":
        with pytest.raises(ValueError, match="normal=True"):
            fn(top, ty, niter=2, show=True, normal=True)
    # fused=False takes the class path with no hooks at all
    x, *rest = fn(top, ty, niter=3, tol=0.0, fused=False)
    close(x.asarray(), fn(top, ty, niter=3, tol=0.0)[0].asarray(), RTOL)
