"""The frequency-split operators and the two pipelines across ranks,
held against the JAX package on a mesh of the same size:
``MPIFredholm1`` (BROADCAST vectors with a ragged gather of the slices,
and the slice-aligned SCATTER layout with no collective; with and
without ``saveGt``; ``(N, K)`` blocks; the layout error), ``MPIMDC``
(``examples/plot_mdc.py``), ``models.mdd`` (``examples/mdd.py``),
``MPILSM`` and ``models.lsm`` (``examples/lsm.py``), with dot tests and
CGLS; what each rank stores (its chunk of ``G``, its batch's travel-time
tables); the ``convert`` chunking of a kernel; the positional order of
the constructors.

One gloo world per world size runs every case (``run_world`` of
``test_torch_process_group.py``), the JAX reference in this process
meanwhile. Tolerance: rtol 1e-12 in f64 for applies, 1e-10 for CGLS (5
to 20 iterations); ``mdd``'s 200 iterations 1e-9, as at one rank
(``test_torch_mdd.py``); ``lsm``'s CGLS amplifies summation order
(receivers on grid points give amplitudes up to 1e5; the JAX package
differs from itself by 10% between layouts after ~12 iterations), so it
is held over five iterations at 1e-9, as in ``test_torch_lsm.py``.
"""

import numpy as np
import pytest
import torch

from test_torch_process_group import WORLDS, close, jax_mesh, run_world


def _lsm_example():
    """examples/lsm.py's geometry, wavelet and two-interface model."""
    from pylops_mpi_tpu_torch.models import ricker
    nx, nz, dx = 81, 60, 4
    x, z = np.arange(nx) * dx, np.arange(nz) * dx
    refl = np.zeros((nz, nx))
    refl[30] = -1.0
    refl[50] = 0.5
    nr, ns = 11, 16
    recs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, nr),
                      20 * np.ones(nr)))
    srcs = np.vstack((np.linspace(10 * dx, (nx - 10) * dx, ns),
                      10 * np.ones(ns)))
    t = np.arange(400) * 0.002
    wav, _ = ricker(t[:21], f0=20)
    return dict(z=z, x=x, t=t, sources=srcs, recs=recs, vel=1000.0,
                wav=wav, wavcenter=len(wav) // 2), refl


def _data():
    rng = np.random.default_rng(13)

    def c(*s):
        return rng.standard_normal(s) + 1j * rng.standard_normal(s)

    # Fredholm: 7 slices (ragged over 2-4 ranks), 12 (slice-aligned)
    d = dict(G7=c(7, 4, 3), G12=c(12, 4, 3))
    for k in ("7", "12"):
        nsl = int(k)
        d["x" + k], d["y" + k] = c(nsl * 3 * 2), c(nsl * 4 * 2)
        d["X" + k] = c(nsl * 3 * 2, 3)
    # examples/plot_mdc.py (nt 32, one-sided) and examples/mdd.py
    nt, nr, ns, nv = 32, 6, 10, 2
    d["Gmdc"] = c(nt // 2 + 1, ns, nr)
    d["xmdc"] = rng.standard_normal(nt * nr * nv)
    r3 = np.random.default_rng(3)
    Gt = r3.standard_normal((6, 4, 33)) * np.exp(
        -0.2 * np.arange(33))[None, None, :]
    d["Gmdd"] = np.moveaxis(np.fft.rfft(Gt, 33, axis=-1), -1, 0)
    d["xmdd"] = r3.standard_normal(33 * 4)
    d["dlsm"] = rng.standard_normal(16 * 11 * 400)
    return d


def _unaligned(size, n):
    """A SCATTER split that is not slice-aligned past one rank."""
    return [(size - n + 1,)] + [(1,)] * (n - 1)


# --------------------------------------------------------------- ranks

def _fredholm_rank(d):
    import importlib
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.parallel import collectives as co
    lsm_mod = importlib.import_module("pylops_mpi_tpu_torch.models.lsm")
    bc = pmtt.Partition.BROADCAST
    out = {}

    def vec(a, **kw):
        return D.to_dist(a, device="cpu", **kw)

    for k in ("7", "12"):
        for save in (False, True):
            F = pmtt.convert.fredholm_from_numpy(d["G" + k], nz=2,
                                                 saveGt=save, device="cpu")
            co.reset_counts()
            y = F.matvec(vec(d["x" + k], partition=bc))
            calls = (dict(co.counts), dict(co.received))
            o = dict(y=y.asarray(), part=y.partition.name, calls=calls,
                     G=F.G.numpy(), GT=None if F.GT is None
                     else tuple(F.GT.shape),
                     xa=F.rmatvec(vec(d["y" + k], partition=bc)).asarray(),
                     Y=F.matvec(vec(d["X" + k], partition=bc)).asarray(),
                     lsm=(F.model_local_shapes, F.data_local_shapes))
            u = vec(d["x" + k], partition=bc)
            o["dot"] = pmtt.dottest(F, u, vec(d["y" + k], partition=bc),
                                    rtol=1e-12)
            if F.model_local_shapes is not None:
                xs = vec(d["x" + k], local_shapes=F.model_local_shapes)
                co.reset_counts()
                ys = F.matvec(xs)
                xas = F.rmatvec(ys)
                o["scatter"] = dict(y=ys.array.numpy(), xa=xas.array.numpy(),
                                    calls=dict(co.counts),
                                    lsh=(ys.local_shapes, xas.local_shapes))
                o["scatter"]["Y"] = F.matvec(vec(
                    d["X" + k], local_shapes=[s + (3,) for s in
                                              F.model_local_shapes])
                ).array.numpy()
                o["scatter"]["dot"] = pmtt.dottest(F, xs, ys.copy(),
                                                   rtol=1e-12)
            try:
                F.matvec(vec(d["x" + k], local_shapes=_unaligned(
                    d["x" + k].size, pmtt.parallel.world_size())))
                o["error"] = None
            except ValueError as e:
                o["error"] = str(e)
            if not save:
                o["cgls"] = pmtt.cgls(F, y, x0=vec(np.zeros_like(d["x" + k]),
                                                   partition=bc),
                                      niter=5, tol=0.0)[0].asarray()
            out[f"fredholm{k}_{int(save)}"] = o
    # examples/plot_mdc.py
    M = pmtt.MPIMDC(d["Gmdc"], 32, 2, None, 0.004, 1.0, False,
                    device="cpu")
    xd = vec(d["xmdc"], partition=bc)
    y = M.matvec(xd)
    Fr = M.args[0].args[0].args[1]
    out["mdc"] = dict(y=y.asarray(), xa=M.rmatvec(y).asarray(),
                      G=tuple(Fr.G.shape), GT=tuple(Fr.GT.shape),
                      dot=pmtt.dottest(M, xd, y.copy(), rtol=1e-10),
                      cgls=pmtt.cgls(M, y, x0=vec(np.zeros(d["xmdc"].size),
                                                  partition=bc),
                                     niter=20, tol=0.0)[0].asarray())
    # examples/mdd.py: its data through the operator, then mdd
    Op = pmtt.MPIMDC(d["Gmdd"], nt=33, nv=1, twosided=True, device="cpu")
    dd = Op.matvec(vec(d["xmdd"], partition=bc)).asarray().reshape(33, 6, 1)
    minv, _ = pmtt.models.mdd(d["Gmdd"], dd, 33, 1, 1.0, 1.0, True, 200,
                              device="cpu")
    out["mdd"] = dict(d=dd, minv=minv)
    # examples/lsm.py: each rank builds its own batch's tables only
    geo, refl = _lsm_example()
    L = lsm_mod.MPILSM(**geo, dtype=torch.float64, device="cpu")
    spray = [op.B for op in L.ops]
    m = vec(refl.ravel(), partition=bc)
    yl = L.matvec(m)
    out["lsm"] = dict(
        tables=[tuple(s.index.shape) for s in spray],
        rows=[op.shape for op in L.ops], lsn=L.local_shapes_n,
        y=yl.array.numpy(),
        xa=L.rmatvec(vec(d["dlsm"], local_shapes=L.local_shapes_n)).asarray(),
        dot=pmtt.dottest(L, rtol=1e-10, device="cpu"))
    minv, dl, cost = lsm_mod.lsm(**geo, refl=refl, niter=5,
                                 dtype=torch.float64, device="cpu")
    out["lsm"].update(minv=minv, d=dl, cost=cost)
    return out


# ------------------------------------------------------------ reference

def _reference(n, d):
    import importlib
    import pylops_mpi_tpu as pmt
    jlsm = importlib.import_module("pylops_mpi_tpu.models.lsm")
    from pylops_mpi_tpu.models import mdd
    mesh = jax_mesh(n)
    J = pmt.DistributedArray
    bc = pmt.Partition.BROADCAST
    ref = {}

    def vec(a, **kw):
        return J.to_dist(a, mesh=mesh, **kw)

    for k in ("7", "12"):
        F = pmt.MPIFredholm1(d["G" + k], nz=2, mesh=mesh,
                             dtype=np.complex128)
        y = F.matvec(vec(d["x" + k], partition=bc))
        o = dict(y=y.asarray(),
                 xa=F.rmatvec(vec(d["y" + k], partition=bc)).asarray(),
                 Y=F.matvec(vec(d["X" + k], partition=bc)).asarray(),
                 lsm=(F.model_local_shapes, F.data_local_shapes),
                 cgls=pmt.cgls(F, y, x0=vec(np.zeros_like(d["x" + k]),
                                             partition=bc),
                               niter=5, tol=0.0)[0].asarray())
        if F.model_local_shapes is not None:
            ys = F.matvec(vec(d["x" + k], local_shapes=F.model_local_shapes))
            o["scatter"] = dict(
                y=ys.local_arrays(), xa=F.rmatvec(ys).local_arrays(),
                Y=F.matvec(vec(d["X" + k], local_shapes=[
                    s + (3,) for s in F.model_local_shapes])).local_arrays())
        try:
            F.matvec(vec(d["x" + k], local_shapes=_unaligned(
                d["x" + k].size, n)))
            o["error"] = None
        except ValueError as e:
            o["error"] = str(e)
        ref["fredholm" + k] = o
    M = pmt.MPIMDC(d["Gmdc"], nt=32, nv=2, dt=0.004, dr=1.0, twosided=False,
                   mesh=mesh)
    y = M.matvec(vec(d["xmdc"], partition=bc))
    ref["mdc"] = dict(y=y.asarray(), xa=M.rmatvec(y).asarray(),
                      cgls=pmt.cgls(M, y, x0=vec(np.zeros(d["xmdc"].size),
                                                 partition=bc),
                                    niter=20, tol=0.0)[0].asarray())
    Op = pmt.MPIMDC(d["Gmdd"], nt=33, nv=1, twosided=True, mesh=mesh)
    dd = Op.matvec(vec(d["xmdd"], partition=bc)).asarray().reshape(33, 6, 1)
    ref["mdd"] = dict(d=dd, minv=mdd(d["Gmdd"], dd, nt=33, nv=1, niter=200,
                                     mesh=mesh)[0])
    geo, refl = _lsm_example()
    L = jlsm.MPILSM(**geo, mesh=mesh, dtype=np.float64)
    yl = L.matvec(vec(refl.ravel(), partition=bc))
    minv, dl, cost = jlsm.lsm(**geo, refl=refl, niter=5, mesh=mesh,
                              dtype=np.float64)
    dlsm = vec(d["dlsm"], local_shapes=L.local_shapes_n)
    ref["lsm"] = dict(y=yl.local_arrays(), lsn=L.local_shapes_n,
                      xa=L.rmatvec(dlsm).asarray(), minv=minv, d=dl,
                      cost=cost)
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = _data()
    out = {}
    for n in WORLDS:
        out[n] = run_world(_fredholm_rank, n, tmp_path_factory.mktemp("w"),
                           d, during=lambda: _reference(n, d))
    return d, out


def _each(worlds):
    d, out = worlds
    for n, (res, ref) in out.items():
        for r, o in enumerate(res):
            yield n, r, o, ref


# ---------------------------------------------------------------- cases

@pytest.mark.parametrize("k", ["7", "12"])
def test_fredholm_broadcast(worlds, k):
    """Each rank applies its chunk of the slices and gathers the rest
    (one ragged all_gather for 7 slices over 2-4 ranks)."""
    d = worlds[0]
    G = d["G" + k]
    for n, r, o, ref in _each(worlds):
        w = ref["fredholm" + k]
        lo = [0] + list(np.cumsum([len(c) for c in np.array_split(
            np.arange(G.shape[0]), n)]))
        for save in (0, 1):
            v = o[f"fredholm{k}_{save}"]
            # only the rank's chunk of G (and of Gᴴ) is stored
            np.testing.assert_array_equal(v["G"], G[lo[r]:lo[r + 1]])
            assert v["GT"] == ((lo[r + 1] - lo[r], 3, 4) if save else None)
            assert v["part"] == "BROADCAST"
            calls, received = v["calls"]
            assert calls == ({} if n == 1 else {"all_gather": 1})
            if n > 1:  # the padded chunks of every other rank
                biggest = lo[1] - lo[0]
                assert received == {"all_gather":
                                    (n - 1) * biggest * 4 * 2 * 16}
            close(v["y"], w["y"])
            close(v["xa"], w["xa"])
            close(v["Y"], w["Y"])
            assert v["lsm"] == w["lsm"] and v["dot"]
            assert v["error"] == w["error"]
            assert (v["error"] is None) == (n == 1)
        close(o[f"fredholm{k}_0"]["cgls"], w["cgls"], rtol=1e-10)


def test_fredholm_slice_aligned_scatter(worlds):
    """12 slices split over 1-4 ranks: SCATTER model and data in the
    slice-aligned layout, and an apply communicates nothing."""
    for n, r, o, ref in _each(worlds):
        w = ref["fredholm12"]["scatter"]
        assert o["fredholm7_0"].get("scatter") is None or n == 1
        for save in (0, 1):
            v = o[f"fredholm12_{save}"]["scatter"]
            assert v["calls"] == {}
            close(v["y"], w["y"][r])
            close(v["xa"], w["xa"][r])
            close(v["Y"], w["Y"][r])
            assert v["dot"]


def test_mdc_example(worlds):
    """examples/plot_mdc.py: the FFTs on the whole vector on every rank,
    the Fredholm core split over the frequencies."""
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        v, w = o["mdc"], ref["mdc"]
        nf = len(np.array_split(np.arange(17), n)[r])
        assert v["G"] == (nf, 10, 6) and v["GT"] == (nf, 6, 10)
        close(v["y"], w["y"])
        close(v["xa"], w["xa"])
        assert v["dot"]
        close(v["cgls"], w["cgls"], rtol=1e-10)
        assert np.linalg.norm(v["cgls"] - d["xmdc"]) \
            < np.linalg.norm(d["xmdc"])


def test_mdd_example(worlds):
    d = worlds[0]
    for n, r, o, ref in _each(worlds):
        close(o["mdd"]["d"], ref["mdd"]["d"])
        close(o["mdd"]["minv"], ref["mdd"]["minv"], rtol=1e-9)
        close(o["mdd"]["minv"].ravel(), d["xmdd"], rtol=1e-6)


def test_lsm_tables_per_rank(worlds):
    """Each rank builds the travel-time tables of its own batch of
    sources only; the others stand in by their shapes."""
    for n, r, o, ref in _each(worlds):
        v = o["lsm"]
        ns = len(np.array_split(np.arange(16), n)[r])
        assert v["tables"] == [(ns * 11, 60 * 81)]
        assert v["rows"] == [(ns * 11 * 400, 60 * 81)]
        assert v["lsn"] == ref["lsm"]["lsn"]


def test_lsm_example(worlds):
    for n, r, o, ref in _each(worlds):
        v, w = o["lsm"], ref["lsm"]
        close(v["y"], w["y"][r])
        close(v["xa"], w["xa"])
        assert v["dot"]
        close(v["d"], w["d"])
        close(v["minv"], w["minv"], rtol=1e-9)
        close(v["cost"], w["cost"], rtol=1e-9)


def test_convert_chunks_kernel(worlds):
    """``fredholm_from_numpy``/``mdc_from_numpy`` take the global kernel
    and keep this rank's chunk of its slices (checked per rank in the
    cases above); at one rank the chunk is the whole kernel."""
    d = worlds[0]
    res, _ = worlds[1][1]
    np.testing.assert_array_equal(res[0]["fredholm7_0"]["G"], d["G7"])
    assert res[0]["mdc"]["G"] == d["Gmdc"].shape


# ------------------------------------------------- positional order (pins)

def _mesh_pair():
    import pylops_mpi_tpu_torch as pmtt
    here = pmtt.parallel.make_mesh("cpu")
    return here, pmtt.parallel.Mesh(None, 0, 2, here.device)


def test_fredholm_mdc_positional_order():
    """``MPIFredholm1(G, nz, saveGt, usematmul, mesh, dtype,
    compute_dtype, planar)`` and ``MPIMDC(G, nt, nv, nfreq, dt, dr,
    twosided, saveGt, conj, prescaled, mesh, compute_dtype, engine)``,
    the JAX package's orders; ``device`` keyword-only; a mesh that is not
    the process group is refused."""
    import pylops_mpi_tpu_torch as pmtt
    here, other = _mesh_pair()
    G = _data()["G7"]
    c64, c128 = torch.complex64, torch.complex128
    pos = pmtt.MPIFredholm1(G, 2, True, False, here, c128, c64, False,
                            device="cpu")
    kw = pmtt.MPIFredholm1(G, nz=2, saveGt=True, usematmul=False, mesh=here,
                           dtype=c128, compute_dtype=c64, planar=False,
                           device="cpu")
    for op in (pos, kw):
        assert (op.nz, op.dtype, op.G.dtype) == (2, c128, c64)
        assert op.GT is not None
    with pytest.raises(NotImplementedError, match="planar"):
        pmtt.MPIFredholm1(G, 2, False, True, None, c128, None, True,
                          device="cpu")
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.MPIFredholm1(G, 2, False, True, other, device="cpu")
    Gm = _data()["Gmdc"]
    args = (Gm, 32, 2, 9, 0.004, 2.0, False, False, True, True, here, c64,
            "complex")
    pm = pmtt.MPIMDC(*args, device="cpu")
    km = pmtt.MPIMDC(Gm, nt=32, nv=2, nfreq=9, dt=0.004, dr=2.0,
                     twosided=False, saveGt=False, conj=True, prescaled=True,
                     mesh=here, compute_dtype=c64, engine="complex",
                     device="cpu")
    x = pmtt.DistributedArray.to_dist(_data()["xmdc"], device="cpu",
                                      partition=pmtt.Partition.BROADCAST)
    assert torch.equal(pm.matvec(x).array, km.matvec(x).array)
    Fr = pm.args[0].args[0].args[1].A  # conj wraps the Fredholm core
    assert Fr.G.shape == (9, 10, 6) and Fr.G.dtype == c64 and Fr.GT is None
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.MPIMDC(*args[:10], other, device="cpu")


def test_mdd_lsm_positional_order():
    """``mdd(G, d, nt, nv, dt, dr, twosided, niter, mesh)`` with ``tol``
    and ``device`` keyword-only; ``MPILSM(..., wavcenter, mesh, dtype)``
    and ``lsm(..., refl, niter, mesh, dtype)``."""
    import importlib
    import pylops_mpi_tpu_torch as pmtt
    lsm_mod = importlib.import_module("pylops_mpi_tpu_torch.models.lsm")
    here, other = _mesh_pair()
    d = _data()
    G = d["Gmdd"]
    Op = pmtt.MPIMDC(G, nt=33, nv=1, device="cpu")
    dd = Op.matvec(pmtt.DistributedArray.to_dist(
        d["xmdd"], partition=pmtt.Partition.BROADCAST, device="cpu")
    ).asarray().reshape(33, 6, 1)
    pos = pmtt.models.mdd(G, dd, 33, 1, 1.0, 1.0, True, 30, here,
                          device="cpu")[0]
    kw = pmtt.models.mdd(G, dd, nt=33, nv=1, dt=1.0, dr=1.0, twosided=True,
                         niter=30, mesh=here, device="cpu")[0]
    np.testing.assert_array_equal(pos, kw)
    with pytest.raises(TypeError):
        pmtt.models.mdd(G, dd, 33, 1, 1.0, 1.0, True, 30, here, 1e-12)
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.models.mdd(G, dd, 33, 1, 1.0, 1.0, True, 30, other,
                        device="cpu")
    geo, refl = _lsm_example()
    g = [geo[k] for k in ("z", "x", "t", "sources", "recs", "vel", "wav",
                          "wavcenter")]
    Lp = lsm_mod.MPILSM(*g, here, torch.float64, device="cpu")
    Lk = lsm_mod.MPILSM(*g, mesh=here, dtype=torch.float64, device="cpu")
    assert Lp.dtype == Lk.dtype == torch.float64 and Lp.shape == Lk.shape
    with pytest.raises(ValueError, match="does not match the process"):
        lsm_mod.MPILSM(*g, other, device="cpu")
    tp = lsm_mod.lsm(*g, refl, 2, here, torch.float64, device="cpu")
    tk = lsm_mod.lsm(*g, refl=refl, niter=2, mesh=here, dtype=torch.float64,
                     device="cpu")
    for a, b in zip(tp, tk):
        np.testing.assert_array_equal(a, b)
