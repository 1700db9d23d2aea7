"""The port's training path held against the JAX package's
(``tests/test_autodiff.py``'s cases): the reroute predicate, the adjoint
VJP rule by
finite difference in both directions and precisions, the parameter
cotangent (dense and sparse), the JVP rule, the wrapper's contract, the
unrolled oracles against the fused solves, the implicit CG/CGLS
gradients (vector and parameter, real and complex, single and block)
against the unrolled ones and against ``jax.grad``, ``x0``'s zero
cotangent, the entry reroute and, with no input that requires grad,
bitwise-unchanged solves with the same kernel calls, the entries that
refuse gradients, ``fit`` on a
quadratic and through a solver, ``FamilySpec(differentiable=)``, the
parameter registry and its conversion from the JAX pytree, the tap
kernel's autograd rule, the normal kernel's refusal and
``checkpointed``.

Every JAX gradient is compared with the port's through
``convert.grad_to_jax`` (the conjugate for complex tensors). Problems
are f64 (f32 where a case says so) with at most 48 unknowns.
Tolerances: the port against the JAX package and against its own
unrolled tape 1e-8 relative (f64, converged solves); finite differences
1e-6 (f64) and 2e-2 (f32) as the JAX package's tests; the complex
convention pinned exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import pylops_mpi_tpu as pmt
from pylops_mpi_tpu.autodiff import (cg_solve as jcg_solve,
                                     cgls_solve as jcgls_solve,
                                     block_cg_solve as jblock_cg_solve,
                                     make_differentiable as jmake_diff,
                                     fit as jfit, unrolled_cg as junrolled_cg)
from pylops_mpi_tpu.ops.local import MatrixMult as JM
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch import DistributedArray as TD
from pylops_mpi_tpu_torch.autodiff import (
    DifferentiableOperator, block_cg_solve, block_cgls_solve, cg_solve,
    cgls_solve, fit, make_differentiable, param_count, trainable_leaves,
    unrolled_cg, unrolled_cgls)
from pylops_mpi_tpu_torch.autodiff import rules
from pylops_mpi_tpu_torch.convert import (grad_from_jax, grad_to_jax,
                                          operator_params_from_jax,
                                          param_grads_to_jax)
from pylops_mpi_tpu_torch.linearoperator import (operator_params,
                                                 params_registered,
                                                 with_params)
from pylops_mpi_tpu_torch.autodiff import implicit
from pylops_mpi_tpu_torch.ops import normal_kernels, stencil_kernels
from pylops_mpi_tpu_torch.solvers import basic as tbasic

RTOL = 1e-8


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = np.asarray(got)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(1.0, np.max(np.abs(want))))


# --------------------------------------------------------------- problems
def spd_mats(rng, nblk=8, nloc=6, dtype=np.float64):
    out = []
    for _ in range(nblk):
        a = rng.standard_normal((nloc, nloc))
        m = a @ a.T * 0.1 + nloc * np.eye(nloc)
        if np.issubdtype(dtype, np.complexfloating):
            b = rng.standard_normal((nloc, nloc)) * 0.1
            m = m + 1j * (b - b.T)  # Hermitian
        out.append(m.astype(dtype))
    return out


def ls_mats(rng, nblk=8, bm=8, bn=5, dtype=np.float64):
    out = [rng.standard_normal((bm, bn)) for _ in range(nblk)]
    if np.issubdtype(dtype, np.complexfloating):
        out = [m + 1j * rng.standard_normal((bm, bn)) for m in out]
    return [m.astype(dtype) for m in out]


def jop(mats):
    return pmt.MPIBlockDiag([JM(m, dtype=m.dtype) for m in mats])


def top(mats):
    return pmtt.convert.blockdiag_from_numpy(mats, device="cpu")


def tvec(v, grad=False):
    d = TD.to_dist(torch.as_tensor(np.asarray(v)).clone(), device="cpu")
    if grad:
        d.array.requires_grad_(True)
    return d


def jvec(v):
    return pmt.DistributedArray.to_dist(np.asarray(v))


def tloss(w, x):
    """``Re⟨w, x⟩`` of a port vector (w a numpy array)."""
    return torch.sum(torch.as_tensor(np.conj(w)) * x.array.reshape(w.shape)
                     ).real


def jloss(w, x):
    return jnp.vdot(jnp.asarray(w), x._arr.reshape(w.shape)).real


# --------------------------------------------------------- reroute and API
def test_should_intercept_predicate(rng):
    """The classic entries reroute exactly when grad mode is on and ``y``,
    ``x0`` or an operator parameter requires grad (JAX
    ``basic.py:911-919``)."""
    Op = top(spd_mats(rng))
    yv = rng.standard_normal(48)
    assert not implicit.should_intercept(Op, tvec(yv))
    assert not implicit.should_intercept(Op, tvec(yv), tvec(yv))
    assert implicit.should_intercept(Op, tvec(yv, grad=True))
    assert implicit.should_intercept(Op, tvec(yv), tvec(yv, grad=True))
    (P,) = operator_params(Op)
    P.requires_grad_(True)
    assert implicit.should_intercept(Op, tvec(yv))
    assert implicit.should_intercept(2.0 * Op, tvec(yv))
    with torch.no_grad():
        assert not implicit.should_intercept(Op, tvec(yv, grad=True))


def test_complex_convention_converted_once():
    """jax.grad(|z|²)(1+1j) = 2−2j; torch's .grad is 2+2j; the
    conversion maps one onto the other (and leaves real values alone)."""
    jg = complex(jax.grad(lambda z: jnp.abs(z) ** 2)(jnp.asarray(1 + 1j)))
    z = torch.tensor(1 + 1j, dtype=torch.complex128, requires_grad=True)
    (z.abs() ** 2).backward()
    assert jg == 2 - 2j and complex(z.grad) == 2 + 2j
    assert complex(grad_to_jax(z.grad)) == jg
    assert complex(grad_from_jax(jg)) == complex(z.grad)
    assert float(grad_to_jax(torch.tensor(3.0))) == 3.0


# ------------------------------------------------------ operator VJP rules
def _fd_dir(f, v, d, h):
    return (float(f(v + h * d)) - float(f(v - h * d))) / (2 * h)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-2),
                                       (np.float64, 1e-6)])
@pytest.mark.parametrize("direction", ["matvec", "rmatvec"])
def test_vjp_rule_vector_fd(rng, dtype, tol, direction):
    """The gradient of ⟨w, A x⟩ through the rule equals the finite
    difference, Aᴴw, and the JAX rule's gradient."""
    mats = spd_mats(rng, dtype=dtype)
    D = make_differentiable(top(mats))
    assert isinstance(D, DifferentiableOperator)
    w = rng.standard_normal(48).astype(dtype)
    xv = rng.standard_normal(48).astype(dtype)

    def f(v):
        x = tvec(v)
        return tloss(w, D.matvec(x) if direction == "matvec"
                     else D.rmatvec(x))

    x = tvec(xv, grad=True)
    out = D.matvec(x) if direction == "matvec" else D.rmatvec(x)
    (g,) = torch.autograd.grad(tloss(w, out), x.array)
    d = np.random.default_rng(0).standard_normal(48).astype(dtype)
    fd = _fd_dir(f, xv, d, 1e-3 if dtype == np.float32 else 1e-6)
    assert float(np.vdot(g.numpy(), d)) == pytest.approx(fd, rel=tol,
                                                         abs=tol)
    import scipy.linalg as spla
    A = spla.block_diag(*mats).astype(np.float64)
    A = A if direction == "matvec" else A.T
    close(g.numpy(), A.T @ w, 10 * tol)
    JD = jmake_diff(jop(mats))
    jg = jax.grad(lambda v: jloss(w, JD.matvec(v) if direction == "matvec"
                                  else JD.rmatvec(v)))(jvec(xv))
    close(g.numpy(), grad_to_jax(np.asarray(jg.asarray())), 10 * tol)


def test_vjp_rule_param_cotangent_fd(rng):
    """The gradient with respect to the operator's own block stack (the
    parameter seam) matches the finite difference and the JAX leaf
    cotangent."""
    mats = spd_mats(rng)
    Op = top(mats)
    D = make_differentiable(Op, params=True)
    xv = rng.standard_normal(48)
    w = rng.standard_normal(48)
    (P,) = operator_params(Op)
    P.requires_grad_(True)
    (g,) = torch.autograd.grad(tloss(w, D.matvec(tvec(xv))), P)
    P.requires_grad_(False)
    idx, h, vals = (1, 2, 3), 1e-6, []
    for s in (+1, -1):
        Q = P.detach().clone()
        Q[idx] += s * h
        vals.append(float(tloss(w, with_params(Op, [Q]).matvec(tvec(xv)))))
    assert float(g[idx]) == pytest.approx((vals[0] - vals[1]) / (2 * h),
                                          rel=1e-5, abs=1e-8)
    JD = jmake_diff(jop(mats), params=True)
    gj = jax.grad(lambda o: jloss(w, o.matvec(jvec(xv))))(JD)
    (jleaf,) = jax.tree_util.tree_leaves(gj)
    close(param_grads_to_jax([g])[0], np.asarray(jleaf))


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-2),
                                       (np.float64, 1e-6)])
def test_jvp_rule_fd(rng, dtype, tol):
    """mode='jvp': the forward-mode tangent of A x is A dx (and of Aᴴx,
    Aᴴdx), as ``jax.jvp`` through the JAX rule gives; a parameter
    tangent adds (dA) x."""
    import torch.autograd.forward_ad as fwAD
    import scipy.linalg as spla
    mats = spd_mats(rng, dtype=dtype)
    Op = top(mats)
    D = make_differentiable(Op, mode="jvp")
    xv = rng.standard_normal(48).astype(dtype)
    dv = rng.standard_normal(48).astype(dtype)
    A = spla.block_diag(*mats).astype(np.float64)
    JD = jmake_diff(jop(mats), mode="jvp")
    for direction, M in (("matvec", A), ("rmatvec", A.T)):
        with fwAD.dual_level():
            x = tvec(xv)
            x._arr = fwAD.make_dual(x.array, torch.as_tensor(dv))
            y = D.matvec(x) if direction == "matvec" else D.rmatvec(x)
            dy = fwAD.unpack_dual(y.array).tangent
        close(dy.numpy().astype(np.float64), M @ dv, tol)
        _, jdy = jax.jvp(lambda v: JD.matvec(v) if direction == "matvec"
                         else JD.rmatvec(v), (jvec(xv),), (jvec(dv),))
        close(dy.numpy(), np.asarray(jdy.asarray()), tol)
    if dtype == np.float64:
        (P,) = operator_params(Op)
        dP = torch.as_tensor(rng.standard_normal(tuple(P.shape)))
        with fwAD.dual_level():
            Pd = fwAD.make_dual(P, dP)
            y = make_differentiable(with_params(Op, [Pd]),
                                    mode="jvp").matvec(tvec(xv))
            dy = fwAD.unpack_dual(y.array).tangent
        dA = spla.block_diag(*dP.numpy())
        close(dy.numpy(), dA @ xv, 1e-10)
    with pytest.raises(RuntimeError, match="mode='jvp'"):
        with fwAD.dual_level():
            x = tvec(xv)
            x._arr = fwAD.make_dual(x.array, torch.as_tensor(dv))
            make_differentiable(Op).matvec(x)


def test_sparse_param_cotangent(rng):
    """Sparse values get real cotangents (w[row]·x[col]), the integer
    rows and columns get None; the values' cotangent is the JAX
    package's."""
    from pylops_mpi_tpu.ops.sparse import MPISparseMatrixMult as JSp
    from pylops_mpi_tpu.autodiff import rules as jrules
    n = 16
    dense = np.zeros((n, n))
    ij = rng.integers(0, n, size=(40, 2))
    dense[ij[:, 0], ij[:, 1]] = rng.standard_normal(len(ij))
    J = JSp.from_dense(dense)
    Op = pmtt.convert.sparse_from_numpy(np.asarray(J._rows),
                                        np.asarray(J._cols),
                                        np.asarray(J._data), (n, n),
                                        device="cpu")
    xv, w = rng.standard_normal(n), rng.standard_normal(n)
    gp = rules.param_cotangent(Op, tvec(xv), tvec(w))
    kinds = [p.is_floating_point() for p in operator_params(Op)]
    assert [g is not None for g in gp] == kinds and not all(kinds)
    data_ct = gp[kinds.index(True)].numpy().ravel()
    rows = Op._rows.numpy().ravel().astype(int)
    cols = Op._cols.numpy().ravel().astype(int)
    want = w[rows] * xv[cols]
    mask = Op._data.numpy().ravel() != 0
    close(data_ct[mask], want[mask], 1e-10)
    jg = jrules.param_cotangent(J, jvec(xv), jvec(w))
    jreal = [l for l in jax.tree_util.tree_leaves(jg)
             if getattr(l, "dtype", None) != jax.dtypes.float0]
    jdata = np.asarray(jreal[0]).ravel()
    jmask = np.asarray(J._data).ravel() != 0
    close(np.sort(data_ct[mask]), np.sort(jdata[jmask]), 1e-10)


def test_differentiable_operator_contract(rng):
    Op = top(spd_mats(rng))
    D = make_differentiable(Op)
    assert make_differentiable(D).A is Op          # idempotent
    assert D.shape == Op.shape and D.dtype == Op.dtype
    assert D.H.shape == (Op.shape[1], Op.shape[0])
    assert isinstance(Op.todifferentiable(), DifferentiableOperator)
    with pytest.raises(ValueError, match="vjp.*jvp|jvp.*vjp"):
        make_differentiable(Op, mode="fwd")

    class _Unreg(pmtt.MPILinearOperator):   # subclass, not registered
        pass

    unreg = _Unreg(shape=Op.shape, dtype=Op.dtype)
    assert not params_registered(unreg)
    with pytest.raises(ValueError, match="register_operator_params"):
        make_differentiable(unreg, params=True)
    assert make_differentiable(unreg)._params is False


def test_operator_params_order_and_conversion(rng):
    """operator_params follows the JAX pytree's leaf order through the
    algebra (scaled by a 0-d tensor, sums, products, adjoints, stacks),
    and operator_params_from_jax carries the JAX leaves over."""
    mats = ls_mats(rng)
    eps = torch.tensor(0.3, dtype=torch.float64)
    Op = top(mats)
    Reg = pmtt.MPIFirstDerivative(40, dtype=torch.float64)
    Comp = pmtt.MPIStackedVStack([Op, eps * Reg]) * 2.0
    ps = operator_params(Comp)
    assert len(ps) == 2 and ps[0] is Op._batched and ps[1] is eps
    J = pmt.MPIStackedVStack(
        [jop(mats), jnp.asarray(0.3) * pmt.MPIFirstDerivative(40)]) * 2.0
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(J)
              if jnp.issubdtype(jnp.asarray(l).dtype, jnp.inexact)]
    assert len(leaves) == 3   # the JAX package keeps the Python 2.0
    leaves = leaves[:2]
    leaves[1] = np.asarray(0.7)
    C2 = operator_params_from_jax(Comp, leaves)
    close(operator_params(C2)[0].numpy(), leaves[0], 0)
    assert float(operator_params(C2)[1]) == 0.7 and float(eps) == 0.3
    x = tvec(rng.standard_normal(40))
    y1, y2 = Comp.matvec(x), C2.matvec(x)
    close(y1[0].asarray(), y2[0].asarray(), 0)
    assert not np.allclose(y1[1].asarray(), y2[1].asarray())
    assert len(operator_params((Op.H @ Op) + Op.H @ Op)) == 4
    with pytest.raises(ValueError, match="parameter tensors"):
        with_params(Op, [])


# ----------------------------------------- implicit against unrolled oracle
def test_unrolled_matches_fused_forward(rng):
    """The taped oracles land on the fused solves' iterates (and on the
    JAX package's unrolled CG)."""
    mats = spd_mats(rng)
    Op, yv = top(mats), rng.standard_normal(48)
    xf = pmtt.cg(Op, tvec(yv), niter=25, tol=0.0)[0]
    xu = unrolled_cg(Op, tvec(yv), niter=25)
    close(xu.asarray(), xf.asarray(), 1e-10)
    close(xu.asarray(), np.asarray(junrolled_cg(jop(mats), jvec(yv),
                                                niter=25).asarray()), 1e-10)
    L = ls_mats(rng)
    OpL, yl = top(L), rng.standard_normal(64)
    xfl = pmtt.cgls(OpL, tvec(yl), niter=25, damp=1e-3, tol=0.0)[0]
    xul = unrolled_cgls(OpL, tvec(yl), niter=25, damp=1e-3)
    close(xul.asarray(), xfl.asarray(), 1e-10)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_implicit_cg_gradient_matches_unrolled(rng, dtype):
    """The implicit fixed-point gradient equals the unrolled tape's, the
    analytic A⁻ᴴw, and jax.grad through the JAX rule (conjugated for
    complex)."""
    import scipy.linalg as spla
    mats = spd_mats(rng, dtype=dtype)
    Op = top(mats)
    w = (rng.standard_normal(48) + (1j * rng.standard_normal(48)
                                    if dtype == np.complex128 else 0))
    w = w.astype(dtype)
    yv = (spla.block_diag(*mats) @ rng.standard_normal(48)).astype(dtype)
    y = tvec(yv, grad=True)
    (gi,) = torch.autograd.grad(tloss(w, cg_solve(Op, y, niter=60, tol=0.0)),
                                y.array)
    (gu,) = torch.autograd.grad(tloss(w, unrolled_cg(Op, y, niter=60)),
                                y.array)
    close(gi.numpy(), gu.numpy(), 1e-7)
    A = spla.block_diag(*mats)
    close(gi.numpy(), np.linalg.solve(A.conj().T, w), 1e-7)
    jg = jax.grad(lambda v: jloss(w, jcg_solve(jop(mats), v, niter=60,
                                               tol=0.0)))(jvec(yv))
    close(grad_to_jax(gi), np.asarray(jg.asarray()))


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_implicit_cgls_gradient_matches_unrolled(rng, dtype):
    L = ls_mats(rng, dtype=dtype)
    Op = top(L)
    damp = 1e-2
    w = rng.standard_normal(40).astype(dtype)
    yv = rng.standard_normal(64).astype(dtype)
    y = tvec(yv, grad=True)
    (gi,) = torch.autograd.grad(
        tloss(w, cgls_solve(Op, y, niter=80, damp=damp, tol=0.0)), y.array)
    (gu,) = torch.autograd.grad(
        tloss(w, unrolled_cgls(Op, y, niter=80, damp=damp)), y.array)
    close(gi.numpy(), gu.numpy(), 1e-6)
    import scipy.linalg as spla
    A = spla.block_diag(*L)
    N = A.conj().T @ A + damp ** 2 * np.eye(40)
    close(gi.numpy(), A @ np.linalg.solve(N, w), 1e-7)
    jg = jax.grad(lambda v: jloss(w, jcgls_solve(
        jop(L), v, niter=80, damp=damp, tol=0.0)))(jvec(yv))
    close(grad_to_jax(gi), np.asarray(jg.asarray()))


@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_implicit_param_gradient_fd(rng, solver):
    """The gradient with respect to the block stack through the solve
    matches the finite difference, the unrolled tape and jax.grad with
    respect to the JAX operator's leaf."""
    mats = spd_mats(rng, nloc=4) if solver == "cg" else ls_mats(rng)
    Op = top(mats)
    n, m = Op.shape[1], Op.shape[0]
    w = rng.standard_normal(n)
    yv = rng.standard_normal(m)
    kw = dict(niter=60, tol=0.0) if solver == "cg" else \
        dict(niter=80, damp=1e-2, tol=0.0)
    solve = cg_solve if solver == "cg" else cgls_solve
    unrolled = unrolled_cg if solver == "cg" else unrolled_cgls
    (P,) = operator_params(Op)
    P.requires_grad_(True)
    (g,) = torch.autograd.grad(tloss(w, solve(Op, tvec(yv), **kw)), P)
    ukw = {k: v for k, v in kw.items() if k != "tol"}
    (gu,) = torch.autograd.grad(tloss(w, unrolled(Op, tvec(yv), **ukw)), P)
    P.requires_grad_(False)
    close(g.numpy(), gu.numpy(), 1e-6)
    idx, h, vals = (1, 2, 3), 1e-6, []
    for s in (+1, -1):
        Q = P.detach().clone()
        Q[idx] += s * h
        vals.append(float(tloss(w, solve(with_params(Op, [Q]), tvec(yv),
                                         **kw))))
    assert float(g[idx]) == pytest.approx((vals[0] - vals[1]) / (2 * h),
                                          rel=1e-4, abs=1e-7)
    J = jop(mats)
    leaf = jax.tree_util.tree_leaves(J)[0]
    treedef = jax.tree_util.tree_structure(J)
    jsolve = jcg_solve if solver == "cg" else jcgls_solve
    jg = jax.grad(lambda lf: jloss(w, jsolve(
        jax.tree_util.tree_unflatten(treedef, [lf]), jvec(yv), **kw)))(
        jnp.asarray(leaf))
    close(param_grads_to_jax([g])[0], np.asarray(jg))


def test_implicit_scaled_regularizer_gradient(rng):
    """ε of a scaled regularizer (a 0-d tensor parameter) through
    cgls_solve on a stacked operator: the JAX package's learned-
    regularization seam, against jax.grad."""
    L = ls_mats(rng, nblk=8, bm=6, bn=5)
    Op = top(L)
    eps = torch.tensor(0.4, dtype=torch.float64, requires_grad=True)
    Reg = pmtt.MPIFirstDerivative(40, dtype=torch.float64)
    yv = rng.standard_normal(48)
    mt = rng.standard_normal(40)
    S = pmtt.MPIStackedVStack([Op, eps * Reg])
    y = pmtt.StackedDistributedArray([tvec(yv), tvec(np.zeros(40))])
    x = cgls_solve(S, y, niter=120, damp=1e-3, tol=0.0)
    loss = torch.sum((x.array - torch.as_tensor(mt)) ** 2)
    (g,) = torch.autograd.grad(loss, eps)

    def jl(e):
        JS = pmt.MPIStackedVStack([jop(L), e * pmt.MPIFirstDerivative(40)])
        jy = pmt.StackedDistributedArray([jvec(yv), jvec(np.zeros(40))])
        xx = jcgls_solve(JS, jy, jvec(np.zeros(40)), niter=120, damp=1e-3,
                         tol=0.0)
        return jnp.sum((xx._arr.ravel() - jnp.asarray(mt)) ** 2)

    close(float(g), float(jax.jit(jax.grad(jl))(jnp.asarray(0.4))), 1e-7)


def test_block_implicit_gradients(rng):
    """(n, K) carries: one block backward solve gives each column the
    single-RHS gradient; block CGLS matches the JAX block rule."""
    mats = spd_mats(rng)
    Op = top(mats)
    K = 3
    cols = rng.standard_normal((48, K))
    w = rng.standard_normal((48, K))
    yb = tvec(cols, grad=True)
    (gb,) = torch.autograd.grad(tloss(w, block_cg_solve(Op, yb, niter=60,
                                                       tol=0.0)), yb.array)
    for k in range(K):
        y = tvec(cols[:, k], grad=True)
        (gk,) = torch.autograd.grad(tloss(w[:, k], cg_solve(
            Op, y, niter=60, tol=0.0)), y.array)
        close(gb[:, k].numpy(), gk.numpy(), 1e-8)
    jg = jax.grad(lambda v: jloss(w, jblock_cg_solve(jop(mats), v, niter=60,
                                                     tol=0.0)))(jvec(cols))
    close(gb.numpy(), np.asarray(jg.asarray()))
    L = ls_mats(rng)
    ybl = tvec(np.stack([rng.standard_normal(64)] * K, axis=1), grad=True)
    x = block_cgls_solve(top(L), ybl, niter=40, damp=1e-2, tol=0.0)
    (g,) = torch.autograd.grad(torch.sum(x.array * x.array), ybl.array)
    assert torch.all(torch.isfinite(g)) and torch.any(g != 0)


def test_x0_zero_cotangent(rng):
    """The converged iterate does not depend on the start."""
    Op = top(spd_mats(rng))
    x0 = tvec(rng.standard_normal(48), grad=True)
    x = cg_solve(Op, tvec(rng.standard_normal(48)), x0, niter=60, tol=0.0)
    (g,) = torch.autograd.grad(torch.sum(x.array ** 2), x0.array)
    assert torch.all(g == 0)


# ------------------------------------------------- entries: knob on and off
@pytest.fixture
def counted(monkeypatch):
    """The CPU's plain normal product counted as the kernel launch is."""
    plain = normal_kernels.normal_matvec
    calls = []

    def launch(A, X):
        calls.append(1)
        return plain(A, X)
    monkeypatch.setattr(normal_kernels, "normal_matvec", launch)
    return calls


def test_solves_without_grad_bitwise_and_same_launches(rng, counted):
    """With no input that requires grad, an entry under grad mode runs
    the fused loop as under ``no_grad`` and as the loop called directly:
    bitwise the same x and the same normal-kernel calls."""
    L = ls_mats(rng)
    Op = top(L)
    OpS = top(spd_mats(np.random.default_rng(1)))
    yv = rng.standard_normal(64)

    def entries():
        return (pmtt.cgls(Op, tvec(yv), niter=12, tol=0.0, normal=True)[0],
                pmtt.cg(OpS, tvec(yv[:48]), niter=12, tol=0.0)[0])

    def under_no_grad():
        with torch.no_grad():
            return entries()

    def direct():
        return (tbasic._solve_cgls(Op, tvec(yv), None, 12, 0.0, 0.0, True,
                                   None, False)[0],
                tbasic._solve_cg(OpS, tvec(yv[:48]), None, 12, 0.0, None,
                                 False)[0])
    base = None
    for run in (entries, under_no_grad, direct):
        counted.clear()
        x, xc = run()
        got = (x.array.clone(), xc.array.clone(), len(counted))
        if base is None:
            base = got
        assert torch.equal(got[0], base[0]) and torch.equal(got[1], base[1])
        assert got[2] == base[2] == 12
        assert not x.array.requires_grad


def test_entries_refuse_grad_they_cannot_carry(rng):
    """An input that requires grad: the guarded entries, the host-only
    options (callback, show, fused=False) and the normal kernel raise;
    nothing returns a detached x. Outside grad mode nothing changes."""
    Op = top(spd_mats(rng))
    y = tvec(rng.standard_normal(48), grad=True)
    for call in (lambda: pmtt.cg_guarded(Op, y, niter=3),
                 lambda: pmtt.cgls_guarded(Op, y, niter=3)):
        with pytest.raises(RuntimeError, match="guards"):
            call()
    for call in (lambda: pmtt.cg(Op, y, niter=3, fused=False),
                 lambda: pmtt.cgls(Op, y, niter=3, callback=lambda *_: 0)):
        with pytest.raises(ValueError, match="fused path"):
            call()
    (P,) = operator_params(Op)
    P.requires_grad_(True)
    with pytest.raises(RuntimeError, match="guards"):
        pmtt.cg_guarded(Op, tvec(rng.standard_normal(48)), niter=3)
    with pytest.raises(NotImplementedError, match="no backward"):
        normal_kernels.normal_matvec(P, torch.ones(8, 6,
                                                   dtype=torch.float64))
    with torch.no_grad():   # outside grad mode nothing changes
        pmtt.cg(Op, tvec(rng.standard_normal(48)), niter=3)
        normal_kernels.normal_matvec(P, torch.ones(8, 6, dtype=torch.float64))


def test_entry_reroute(rng):
    """The classic entries route inputs that require grad through the
    implicit rule with their host contracts; values equal the plain
    solve's, gradients the explicit API's."""
    mats = spd_mats(rng)
    Op = top(mats)
    yv = rng.standard_normal(48)
    xh, ith, _ = pmtt.cg(Op, tvec(yv), niter=25, tol=0.0)
    y = tvec(yv, grad=True)
    x, it, cost = pmtt.cg(Op, y, niter=25, tol=0.0)
    assert it == ith and x.array.requires_grad and not cost.requires_grad
    close(x.asarray(), xh.asarray(), 1e-12)
    (g,) = torch.autograd.grad(x.array.sum(), y.array)
    y2 = tvec(yv, grad=True)
    (g2,) = torch.autograd.grad(cg_solve(Op, y2, niter=25,
                                         tol=0.0).array.sum(), y2.array)
    close(g.numpy(), g2.numpy(), 1e-12)
    OpL, yl = top(ls_mats(rng)), rng.standard_normal(64)
    th = pmtt.cgls(OpL, tvec(yl), niter=25, damp=1e-3, tol=0.0)
    tg = pmtt.cgls(OpL, tvec(yl, grad=True), niter=25, damp=1e-3, tol=0.0)
    assert len(tg) == len(th) == 6 and tg[2] == th[2] and tg[1] == th[1]
    close(tg[0].asarray(), th[0].asarray(), 1e-12)
    assert float(tg[4]) == pytest.approx(float(th[4]), rel=1e-12)
    with pytest.raises(ValueError, match="fused path"):
        pmtt.cg(Op, tvec(yv, grad=True), niter=5, callback=lambda *_: None)


def test_entry_reroute_block(rng):
    Op = top(spd_mats(rng))
    Y = rng.standard_normal((48, 2))
    xh, ith, _ = pmtt.block_cg(Op, tvec(Y), niter=25, tol=0.0)
    xg, itg, _ = pmtt.block_cg(Op, tvec(Y, grad=True), niter=25, tol=0.0)
    assert itg == ith and xg.array.requires_grad
    close(xg.asarray(), xh.asarray(), 1e-12)
    tj = pmtt.block_cgls(Op, tvec(Y, grad=True), niter=10, damp=1e-3,
                         tol=0.0)
    assert len(tj) == 6 and torch.all(torch.isfinite(tj[0].array))


# -------------------------------------------------------------------- fit
def test_fit_quadratic(rng):
    """Adam and SGD reach the quadratic's minimum along the JAX package's
    trajectory, skipping integer leaves."""
    target = rng.standard_normal(6)
    for opt in ("adam", "sgd"):
        params = {"w": torch.zeros(6, dtype=torch.float64),
                  "n": torch.tensor(3)}
        out, losses = fit(lambda p: torch.sum(
            (p["w"] - torch.as_tensor(target)) ** 2), params, steps=200,
            lr=0.1, optimizer=opt)
        assert out is params and int(out["n"]) == 3
        assert losses[-1] < 1e-2 * losses[0]
        _, jl = jfit(lambda p: jnp.vdot(p["w"] - target, p["w"] - target
                                        ).real,
                     {"w": jnp.zeros(6), "n": 3}, steps=200, lr=0.1,
                     optimizer=opt)
        close(losses, np.asarray(jl), 1e-10)
    assert param_count({"w": torch.zeros(6), "n": torch.tensor(3)}) == 6
    assert len(trainable_leaves([torch.zeros(6), torch.tensor(3)])) == 1


def test_fit_learned_scale_through_solver(rng):
    """Learn a scalar operator weight through cgls_solve, in place: the
    operator is built once, and the loss trajectory is the JAX
    package's."""
    L = ls_mats(rng, nblk=8, bm=6, bn=4)
    Op = top(L)
    import scipy.linalg as spla
    A = spla.block_diag(*L)
    yv = A @ rng.standard_normal(32)
    xt = np.linalg.lstsq(A, yv, rcond=None)[0]
    s = torch.tensor(float(np.exp(0.5)), dtype=torch.float64)
    Sop = s * Op   # a 0-d parameter the operator holds, updated in place

    def loss_s(p):
        x = cgls_solve(Sop, tvec(yv), niter=60, damp=1e-6, tol=0.0)
        return torch.sum((x.array - torch.as_tensor(xt)) ** 2)

    _, losses = fit(loss_s, [s], steps=40, lr=0.2)
    assert losses[-1] < 1e-2 * losses[0]
    assert abs(float(s) - 1.0) < 0.1

    def jl(sv):
        x = jcgls_solve(sv * jop(L), jvec(yv), niter=60, damp=1e-6, tol=0.0)
        d = x._arr.ravel() - jnp.asarray(xt)
        return jnp.vdot(d, d).real

    _, jlosses = jfit(jax.jit(jl), jnp.asarray(float(np.exp(0.5))), steps=40,
                      lr=0.2)
    close(losses, np.asarray(jlosses), 1e-6)


# --------------------------------------------------- serving, kernels, misc
def test_familyspec_differentiable_signature():
    from pylops_mpi_tpu_torch.serving.engine import FamilySpec
    Op = pmtt.MPILinearOperator(shape=(8, 8), dtype=np.float64)
    a = FamilySpec("f", Op)
    b = FamilySpec("f", Op, differentiable=False)
    c = FamilySpec("f", Op, differentiable=True)
    assert a.signature() == b.signature()     # default keeps old keys
    assert c.signature() != a.signature()
    assert c.signature()[:len(a.signature())] == a.signature()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tap_rule_matches_plain_autograd(rng, dtype):
    """The tap stencil's Function (the transposed stencil as its
    backward, ghost pieces included) against autograd through the plain
    version: f64 to 1e-14, f32 to 1e-6 relative."""
    tol = 1e-14 if dtype == torch.float64 else 1e-6
    for taps, w, pad in ((((-1, -0.5), (1, 0.5)), 1, (1, 1)),
                         (((-2, 0.3), (-1, -1.1), (0, 0.2), (2, 0.7)), 2,
                          (0, 3))):
        slab = torch.tensor(rng.standard_normal((13, 4)), dtype=dtype,
                            requires_grad=True)
        top_ = torch.tensor(rng.standard_normal((w, 4)), dtype=dtype,
                            requires_grad=True)
        y = stencil_kernels.stencil_taps(slab, taps, w, pad, top=top_,
                                         bottom=w)
        yp = stencil_kernels.stencil_taps_plain(slab, taps, w, pad,
                                                top=top_, bottom=w)
        assert torch.equal(y, yp)
        gy = torch.tensor(rng.standard_normal(tuple(y.shape)), dtype=dtype)
        got = torch.autograd.grad(y, (slab, top_), gy)
        want = torch.autograd.grad(yp, (slab, top_), gy)
        for a, b in zip(got, want):
            close(a.double().numpy(), b.double().numpy(), tol)


def test_derivative_gradient_matches_jax(rng):
    """examples/autodiff.py's objective on one rank: torch.autograd
    through MPIBlockDiag and the axis-0 MPIFirstDerivative (the tap
    rule) equals jax.grad and the hand-written Aᵀ(Ax−y) + 0.1·DᵀD x."""
    blocks = [rng.standard_normal((8, 8)) + 8 * np.eye(8) for _ in range(4)]
    Aop = top(blocks)
    Dop = pmtt.MPIFirstDerivative((32,), dtype=torch.float64)
    xv, yv = rng.standard_normal(32), rng.standard_normal(32)
    x = tvec(xv, grad=True)
    r = Aop.matvec(x) - tvec(yv)
    d = Dop.matvec(x)
    obj = 0.5 * r.dot(r) + 0.05 * d.dot(d)
    (g,) = torch.autograd.grad(obj, x.array)
    with torch.no_grad():
        xx = tvec(xv)
        want = Aop.rmatvec(Aop.matvec(xx) - tvec(yv)).array \
            + 0.1 * Dop.rmatvec(Dop.matvec(xx)).array
    close(g.numpy(), want.numpy(), 1e-12)
    JA, JD = jop(blocks), pmt.MPIFirstDerivative((32,))
    jy = jvec(yv)

    def jobj(v):
        rr = JA.matvec(v) - jy
        dd = JD.matvec(v)
        return 0.5 * jnp.vdot(rr._arr, rr._arr).real \
            + 0.05 * jnp.vdot(dd._arr, dd._arr).real

    jg = jax.jit(jax.grad(jobj))(jvec(xv))
    close(g.numpy(), np.asarray(jg.asarray()), 1e-12)


def test_checkpointed_gradient(rng):
    """Op.checkpointed() recomputes in the backward and gives the same
    gradient as the plain operator."""
    Op = top(spd_mats(rng))
    D = pmtt.MPIFirstDerivative((48,), dtype=torch.float64)
    C = (D @ Op).checkpointed()
    assert C.shape == Op.shape
    xv = rng.standard_normal(48)
    x1, x2 = tvec(xv, grad=True), tvec(xv, grad=True)
    (g1,) = torch.autograd.grad(C.matvec(x1).array.pow(2).sum(), x1.array)
    (g2,) = torch.autograd.grad((D @ Op).matvec(x2).array.pow(2).sum(),
                                x2.array)
    close(g1.numpy(), g2.numpy(), 1e-14)
    close(C.H.matvec(tvec(xv)).asarray(),
          (D @ Op).H.matvec(tvec(xv)).asarray(), 1e-14)


def test_unregistered_operator_with_grad_is_refused(rng):
    """An operator that holds a tensor requiring grad but is not
    registered cannot hand its gradient on: the solve raises."""
    Op = top(spd_mats(rng))

    class _Wrap(pmtt.MPILinearOperator):
        def __init__(self, A):
            super().__init__(shape=A.shape, dtype=A.dtype)
            self.A = A
            self.scale = torch.tensor(1.0, dtype=torch.float64,
                                      requires_grad=True)

        def _matvec(self, x):
            return self.A.matvec(x) * self.scale

        def _rmatvec(self, x):
            return self.A.rmatvec(x) * self.scale

    with pytest.raises(TypeError, match="register_operator_params"):
        cg_solve(_Wrap(Op), tvec(rng.standard_normal(48)), niter=5)


def test_host_scalar_keys_the_graph():
    """A one-element host tensor (a scaled operator's ε on the CPU) keys
    the graph bank by its value, so an in-place update never replays a
    graph that baked the old value."""
    from pylops_mpi_tpu_torch.aot.signature import storage_signature
    eps = torch.tensor(0.5, dtype=torch.float64)
    S = eps * pmtt.MPIFirstDerivative(8, dtype=torch.float64)
    k1 = storage_signature(S)
    with torch.no_grad():
        eps.mul_(2)
    assert storage_signature(S) != k1
