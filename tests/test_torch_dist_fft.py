"""The pencil FFTs across ranks, held against the JAX package on a mesh
of the same size: ragged rows (17 over 2-4 ranks), real and complex
transforms with shifts, ``nffts`` and ``norm="1/n"``, the generic path
(``axes[-1] == 0`` and 1-D), a transform that leaves axis 0 alone, and
``fftshift_nd`` of a sharded array.

One gloo world per size 1-4 runs every case (``run_world`` of
``test_torch_process_group.py``), the JAX reference in this process
meanwhile. Checked: values, output ``local_shapes`` (the row-aligned
``data_local_shapes``/``model_local_shapes`` on the aligned path, the
default split on the generic one), the collectives of an apply (two
``all_to_all`` transposes on the aligned path, and the bytes each
receives), an input in the default split, and the adjoint identity.

Gradients: of ``0.5‖F x − v‖²`` with respect to x, by autograd straight
through ``matvec`` (the transposes' ``all_to_all`` rule, one adjoint call
for each), complex and real, against ``jax.grad`` through the JAX
operator (torch's gradient of a complex input conjugated to JAX's
convention), at rtol 1e-10.

Tolerance: rtol 1e-12 of the largest reference entry (f64, complex128).
"""

import numpy as np
import pytest

from test_torch_process_group import WORLDS, close, jax_mesh, run_world

CASES = [
    ("cube", dict(dims=(17, 12, 9), axes=(0, 1, 2))),
    ("real_shift", dict(dims=(16, 12, 9), axes=(0, 1), real=True,
                        dtype="float64", fftshift_after=(True, False))),
    ("real_pad", dict(dims=(17, 10), axes=(0, 1), nffts=(20, 13),
                      real=True, dtype="float64",
                      ifftshift_before=(True, True), norm="1/n")),
    ("generic", dict(dims=(9, 7, 5), axes=(2, 0))),
    ("one_d", dict(dims=(30,), axes=(0,), fftshift_after=True)),
    ("no_axis0", dict(dims=(9, 7, 5), axes=(1, 2), fftshift_after=True)),
]


GRADS = ("cube", "real_shift")


def _aligned(kw):
    return len(kw["dims"]) > 1 and kw["axes"][-1] != 0


def _data():
    rng = np.random.default_rng(31)
    d = {}
    for label, kw in CASES:
        n_in = int(np.prod(kw["dims"]))
        x = rng.standard_normal(n_in)
        if "dtype" not in kw:
            x = x + 1j * rng.standard_normal(n_in)
        d["x_" + label] = x
    d["g"] = rng.standard_normal((11, 6, 4))
    return d


def _data_size(kw):
    import pylops_mpi_tpu_torch as pmtt
    return pmtt.MPIFFTND(**kw).shape[0]


# --------------------------------------------------------------- ranks

def _fft_rank(d, vs):
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    D = pmtt.DistributedArray
    out = {}
    for label, kw in CASES:
        Op = pmtt.MPIFFTND(**kw)
        x = D.to_dist(d["x_" + label], local_shapes=Op.model_local_shapes,
                      device="cpu")
        co.reset_counts()
        y = Op.matvec(x)
        fwd = (dict(co.counts), dict(co.received))
        v = D.to_dist(vs[label], local_shapes=Op.data_local_shapes,
                      device="cpu")
        co.reset_counts()
        xa = Op.rmatvec(v)
        adj = (dict(co.counts), dict(co.received))
        # an input in the default split is re-split first
        ydef = Op.matvec(D.to_dist(d["x_" + label], device="cpu"))
        out[label] = dict(y=y.asarray(), y_lsh=y.local_shapes,
                          xa=xa.asarray(), xa_lsh=xa.local_shapes,
                          fwd=fwd, adj=adj, ydef=ydef.asarray(),
                          ydef_lsh=ydef.local_shapes,
                          lsh=(Op.model_local_shapes, Op.data_local_shapes))
    g = D.to_dist(d["g"], device="cpu")
    out["shift"] = (pmtt.utils.fftshift_nd(g, axes=(0, 2)).asarray(),
                    pmtt.utils.ifftshift_nd(g).asarray())
    out["grads"] = _grad_rank(d, vs)
    return out


def _grad_rank(d, vs):
    """GRADS' gradients of 0.5‖F x − v‖² (this rank's shard, in JAX's
    convention) and the collective calls of the forward and backward."""
    import torch
    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.parallel import collectives as co
    D = pmtt.DistributedArray
    out = {}
    for label, kw in CASES:
        if label not in GRADS:
            continue
        Op = pmtt.MPIFFTND(**kw)
        x = D.to_dist(d["x_" + label], local_shapes=Op.model_local_shapes,
                      device="cpu")
        v = D.to_dist(vs[label], local_shapes=Op.data_local_shapes,
                      device="cpu")
        x.array.requires_grad_(True)
        co.reset_counts()
        r = Op.matvec(x) - v
        (g,) = torch.autograd.grad(0.5 * r.dot(r, vdot=True).real, x.array)
        out[label] = dict(grad=pmtt.convert.grad_to_jax(g),
                          calls=dict(co.counts))
    return out


# ------------------------------------------------------------ reference

def _reference(n, d, vs):
    import pylops_mpi_tpu as pmt
    from pylops_mpi_tpu.utils import fft_helper
    mesh = jax_mesh(n)
    J = pmt.DistributedArray
    ref = {}
    for label, kw in CASES:
        Op = pmt.MPIFFTND(mesh=mesh, **kw)
        y = Op.matvec(J.to_dist(d["x_" + label], mesh=mesh,
                                local_shapes=Op.model_local_shapes))
        xa = Op.rmatvec(J.to_dist(vs[label], mesh=mesh,
                                  local_shapes=Op.data_local_shapes))
        ref[label] = dict(y=y.asarray(), y_lsh=y.local_shapes,
                          xa=xa.asarray(), xa_lsh=xa.local_shapes,
                          lsh=(Op.model_local_shapes, Op.data_local_shapes))
    g = J.to_dist(d["g"], mesh=mesh)
    ref["shift"] = (fft_helper.fftshift_nd(g, axes=(0, 2)).asarray(),
                    fft_helper.ifftshift_nd(g).asarray())
    ref["grads"] = _grad_reference(mesh, d, vs)
    return ref


def _grad_reference(mesh, d, vs):
    """``jax.grad`` of GRADS' losses through the JAX operator, gathered."""
    import jax
    import jax.numpy as jnp
    import pylops_mpi_tpu as pmt
    J = pmt.DistributedArray
    ref = {}
    for label, kw in CASES:
        if label not in GRADS:
            continue
        Op = pmt.MPIFFTND(mesh=mesh, **kw)
        x = J.to_dist(d["x_" + label], mesh=mesh,
                      local_shapes=Op.model_local_shapes)
        v = J.to_dist(vs[label], mesh=mesh,
                      local_shapes=Op.data_local_shapes)

        def loss(a, Op=Op, x=x, v=v):
            r = Op.matvec(J._wrap(a, x)) - v
            return 0.5 * jnp.real(r.dot(r, vdot=True))
        ref[label] = J._wrap(jax.jit(jax.grad(loss))(x._arr), x).asarray()
    return ref


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    d = _data()
    rng = np.random.default_rng(32)
    vs = {}
    for label, kw in CASES:
        m = _data_size(kw)
        vs[label] = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    out = {}
    for n in WORLDS:
        out[n] = run_world(_fft_rank, n, tmp_path_factory.mktemp("w"), d, vs,
                           during=lambda: _reference(n, d, vs))
    return d, vs, out


def _each(worlds):
    d, vs, out = worlds
    for n, (res, ref) in out.items():
        for r, o in enumerate(res):
            yield n, r, o, ref


# ---------------------------------------------------------------- cases

@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_matches_jax(worlds, label):
    """Both applies and their output splits against the JAX package
    (row-aligned on the aligned path, the default split on the generic
    one); an input in the default split gives the same output."""
    for n, r, o, ref in _each(worlds):
        v, w = o[label], ref[label]
        close(v["y"], w["y"])
        close(v["xa"], w["xa"])
        assert v["y_lsh"] == w["y_lsh"] and v["xa_lsh"] == w["xa_lsh"]
        assert v["lsh"] == w["lsh"]
        if _aligned(dict(CASES)[label]):
            assert v["y_lsh"] == w["lsh"][1] and v["xa_lsh"] == w["lsh"][0]
        close(v["ydef"], w["y"])
        assert v["ydef_lsh"] == w["y_lsh"]


def test_transposes(worlds):
    """An aligned apply that transforms axis 0 is two ``all_to_all``
    transposes and nothing else; each rank receives every other rank's
    rows of its chunk of the next axis, at their exact sizes. The
    generic path gathers once; a transform that leaves axis 0 alone
    communicates nothing."""
    import pylops_mpi_tpu_torch as pmtt
    for n, r, o, ref in _each(worlds):
        for label, kw in CASES:
            v = o[label]
            if n == 1:
                assert v["fwd"][0] == {} and v["adj"][0] == {}
                continue
            if not _aligned(kw):
                assert v["fwd"][0] == {"all_gather": 1}
                assert v["adj"][0] == {"all_gather": 1}
                continue
            if 0 not in kw["axes"]:
                assert v["fwd"][0] == {} and v["adj"][0] == {}
                continue
            assert v["fwd"][0] == {"all_to_all": 2}
            assert v["adj"][0] == {"all_to_all": 2}
            op = pmtt.MPIFFTND(**kw)
            dims, dimsd = op.dims_nd, op.dimsd_nd
            rows_m = [len(c) for c in np.array_split(np.arange(dims[0]), n)]
            rows_d = [len(c) for c in np.array_split(np.arange(dimsd[0]), n)]
            ch = [len(c) for c in np.array_split(np.arange(dimsd[1]), n)]
            rest = int(np.prod(dimsd[2:]))
            item = 16
            others = [p for p in range(n) if p != r]
            want = item * rest * (
                sum(rows_m[p] for p in others) * ch[r]      # to axis 0
                + rows_d[r] * sum(ch[p] for p in others))   # and back
            assert v["fwd"][1] == {"all_to_all": want}, label


def test_fftshift_nd(worlds):
    for n, r, o, ref in _each(worlds):
        for got, want in zip(o["shift"], ref["shift"]):
            np.testing.assert_array_equal(got, want)


def test_adjoint_identity(worlds):
    """``<Op x, v> = <x, Opᴴ v>`` across ranks (its real part for real
    models)."""
    d, vs, out = worlds
    for n, (res, ref) in out.items():
        for label, kw in CASES:
            o = res[0][label]
            lhs = np.vdot(o["y"], vs[label])
            rhs = np.vdot(d["x_" + label], o["xa"])
            if kw.get("real"):
                lhs, rhs = lhs.real, rhs.real
            np.testing.assert_allclose(lhs, rhs, rtol=1e-11)


@pytest.mark.parametrize("label", GRADS)
def test_gradients_match_jax(worlds, label):
    """x's gradient, each rank's shard of ``jax.grad``'s; a backward
    transpose for each forward one."""
    d, vs, out = worlds
    for n, (res, ref) in out.items():
        close(np.concatenate([o["grads"][label]["grad"] for o in res]),
              ref["grads"][label], 1e-10)
        for o in res:
            calls = o["grads"][label]["calls"]
            assert calls.get("all_to_all_adjoint", 0) == \
                calls.get("all_to_all", 0) == (0 if n == 1 else 2)
