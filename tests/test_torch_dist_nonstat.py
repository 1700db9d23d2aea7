"""``MPINonStationaryConvolve1D`` across ranks (a halo > 0 from two
ranks on), held against the JAX package on a mesh of the same size:
``examples/plot_nonstatconv.py``'s 1-D filter bank and a 2-D field
convolved along axis 0; the halo width, the rank's own local operator,
forward, adjoint, the dot test and CGLS; the divisibility error at three
ranks; the positional order of the factory.

One gloo world per world size runs every case (``run_world`` of
``test_torch_process_group.py``), the JAX reference in this process
meanwhile. The JAX package compiles its halo kernels again at every
apply (1-3 s each on the CPU mesh), so its CGLS reference is the one
on one device, where the sandwich has no halo: with the JAX package's
filter window the sandwich over ranks is the same operator (its forward
and adjoint are held to the JAX package's on every mesh below).
Tolerance: rtol 1e-12 in f64; CGLS (5 iterations) 1e-10.

Gradients: of ``0.5‖Op x − w‖²`` for the 2-D field with respect to x,
by autograd straight through ``matvec`` (the sandwich's halo exchange
and its rule), against ``jax.grad`` through the JAX operator on the
same mesh, each rank's shard at rtol 1e-10.
"""

import numpy as np
import pytest

from test_torch_process_group import WORLDS, close, jax_mesh, run_world


def _cases():
    """name -> (dims, hs, ih): plot_nonstatconv.py's bank on 256 samples
    and a (48, 5) field with six 7-tap filters every 8 samples."""
    from pylops_mpi_tpu_torch.models import ricker
    t = np.arange(17) * 0.004
    hs = np.stack([ricker(t[:9], f0=f)[0]
                   for f in np.linspace(10.0, 40.0, 17)])
    hs2 = np.stack([ricker(t[:4], f0=f)[0]
                    for f in np.linspace(15.0, 30.0, 6)])
    return {"plot_nonstatconv": (256, hs, np.linspace(8, 248, 17).astype(int)),
            "2d": ((48, 5), hs2, np.arange(4, 48, 8))}


def _data():
    x = np.zeros(256)
    x[np.arange(16, 256, 32)] = 1.0  # the example's spike train
    rng = np.random.default_rng(9)
    return {"plot_nonstatconv": (x, rng.standard_normal(256)),
            "2d": (rng.standard_normal(240), rng.standard_normal(240))}


def _nonstat_rank(d):
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch import DistributedArray as D
    from pylops_mpi_tpu_torch.ops.local import NonStationaryConvolve1D
    from pylops_mpi_tpu_torch.parallel import collectives as co
    n = pmtt.parallel.world_size()
    out = {}
    for name, (dims, hs, ih) in _cases().items():
        try:
            # the JAX package's positional order: dims, hs, ih, axis,
            # mesh, dtype
            Op = pmtt.MPINonStationaryConvolve1D(dims, hs, ih, 0, None,
                                                 "float64", device="cpu")
        except ValueError as e:
            out[name] = str(e)
            continue
        HOp, BD = Op.args[1], Op.args[0].args[1]
        x = D.to_dist(d[name][0], device="cpu")
        co.reset_counts()
        y = Op.matvec(x)
        calls = dict(co.counts)
        xa = Op.rmatvec(D.to_dist(d[name][1], device="cpu"))
        own = BD.ops[0]
        out[name] = dict(
            y=y.array.numpy(), xa=xa.array.numpy(), calls=calls,
            halo=HOp._base_halo, lsh=y.local_shapes,
            own=(len(BD.ops), type(own).__name__,
                 isinstance(own, NonStationaryConvolve1D) and tuple(
                     own.hs.shape)),
            dot=pmtt.dottest(Op, rtol=1e-12, device="cpu"),
            cgls=pmtt.cgls(Op, y, niter=5, tol=0.0)[0].asarray())
        if name == "2d":
            x.array.requires_grad_(True)
            co.reset_counts()
            r = Op.matvec(x) - D.to_dist(d[name][1], device="cpu")
            (g,) = torch.autograd.grad(0.5 * r.dot(r), x.array)
            out[name]["grad"] = (g.numpy(), dict(co.counts))
    return out


def _reference(n, d):
    import pylops_mpi_tpu as pmt
    mesh = jax_mesh(n)
    ref = {}
    for name, (dims, hs, ih) in _cases().items():
        try:
            Op = pmt.MPINonStationaryConvolve1D(dims, hs, ih, axis=0,
                                                mesh=mesh, dtype="float64")
        except ValueError as e:
            ref[name] = str(e)
            continue
        J = pmt.DistributedArray
        ref[name] = dict(
            y=Op.matvec(J.to_dist(d[name][0], mesh=mesh)).local_arrays(),
            # the 2-D case's adjoint is held by the dot test only
            xa=Op.rmatvec(J.to_dist(d[name][1], mesh=mesh)).local_arrays()
            if name == "plot_nonstatconv" else None,
            halo=Op.args[1]._base_halo)
        if name == "2d" and n > 1:
            ref[name]["grad"] = _grad_reference(Op, mesh, d[name])
    return ref


def _grad_reference(Op, mesh, data):
    """``jax.grad`` of 0.5‖Op x − w‖², as each rank's shard."""
    import jax
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    x, w = (J.to_dist(v, mesh=mesh) for v in data)

    def loss(a):
        r = Op.matvec(J._wrap(a, x)) - w
        return 0.5 * r.dot(r)
    return J._wrap(jax.jit(jax.grad(loss))(x._arr), x).local_arrays()


def _cgls_reference(d):
    """CGLS through the JAX package's operator on one device."""
    import pylops_mpi_tpu as pmt
    mesh = jax_mesh(1)
    out = {}
    for name, (dims, hs, ih) in _cases().items():
        Op = pmt.MPINonStationaryConvolve1D(dims, hs, ih, axis=0, mesh=mesh,
                                            dtype="float64")
        y = Op.matvec(pmt.DistributedArray.to_dist(d[name][0], mesh=mesh))
        out[name] = pmt.cgls(Op, y, niter=5, tol=0.0)[0].asarray()
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = _data()
    out = {}
    for n in WORLDS:
        out[n] = run_world(_nonstat_rank, n, tmp_path_factory.mktemp("w"), d,
                           during=(lambda: (_reference(n, d),
                                            _cgls_reference(d)))
                           if n == 1 else (lambda: (_reference(n, d),
                                                    None)))
    cg = out[1][1][1]
    return {n: (res, ref) for n, (res, (ref, _)) in out.items()}, cg


@pytest.mark.parametrize("name", ["plot_nonstatconv", "2d"])
def test_nonstat_across_ranks(worlds, name):
    out, cg = worlds
    for n, (res, ref) in out.items():
        w = ref[name]
        if isinstance(w, str):
            # 256 samples over three ranks: the JAX package's error
            assert n == 3 and "not divisible" in w
            assert all(o[name] == w for o in res)
            continue
        for r, o in enumerate(res):
            v = o[name]
            assert v["halo"] == w["halo"]
            assert (max(v["halo"]) > 0) == (n > 1)
            # each rank built its own local operator only
            assert v["own"][:2] == (1, "NonStationaryConvolve1D")
            close(v["y"], w["y"][r])
            if w["xa"] is not None:
                close(v["xa"], w["xa"][r])
            assert v["dot"]
            close(v["cgls"], cg[name], rtol=1e-10)
            # one exchange per forward, along the sharded axis
            assert v["calls"] == ({} if n == 1 else {"cart_halo_extend": 1})


def test_gradient_matches_jax(worlds):
    """Each rank's gradient of the 2-D case is its shard of
    ``jax.grad``'s; the backward sent the ghosts' cotangents home."""
    out, _ = worlds
    for n, (res, ref) in out.items():
        if n == 1 or isinstance(ref["2d"], str):
            continue
        for r, o in enumerate(res):
            g, calls = o["2d"]["grad"]
            close(g, ref["2d"]["grad"][r], 1e-10)
            assert calls["cart_halo_extend_adjoint"] == \
                calls["cart_halo_extend"] == 1


def test_nonstat_positional_order():
    """``MPINonStationaryConvolve1D(dims, hs, ih, axis, mesh, dtype)``;
    ``device`` is keyword-only after them; a mesh that is not the
    process group is refused."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    dims, hs, ih = _cases()["2d"]
    here = pmtt.parallel.make_mesh("cpu")
    pos = pmtt.MPINonStationaryConvolve1D(dims, hs, ih, 0, here, "float32",
                                          device="cpu")
    kw = pmtt.MPINonStationaryConvolve1D(dims=dims, hs=hs, ih=ih, axis=0,
                                         mesh=here, dtype="float32",
                                         device="cpu")
    x = pmtt.DistributedArray.to_dist(_data()["2d"][0].astype(np.float32),
                                      device="cpu")
    for op in (pos, kw):
        assert op.dtype == torch.float32
    assert torch.equal(pos.matvec(x).array, kw.matvec(x).array)
    with pytest.raises(ValueError, match="does not match the process"):
        pmtt.MPINonStationaryConvolve1D(dims, hs, ih, 0,
                                        pmtt.parallel.Mesh(None, 0, 2,
                                                           here.device),
                                        device="cpu")
    with pytest.raises(TypeError):
        pmtt.MPINonStationaryConvolve1D(dims, hs, ih, 0, None, "float32",
                                        "cpu")
