"""The port's MPIBlockDiag held against pylops_mpi_tpu.MPIBlockDiag:
the JAX operator is built first, its blocks are carried over with
``convert.blockdiag_from_numpy`` and both apply the same vectors.

Tolerances, relative to the largest entry of the reference: f64 and
complex128 rtol 1e-12; f32 rtol 1e-5; bf16 storage rtol 1e-5 (both
widen the same bf16 values and accumulate in f32).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu_torch.ops import normal_kernels as nk
from pylops_mpi_tpu_torch.ops.local import MatrixMult as TMatrixMult

NBLK = 8
CASES = {  # name: (numpy dtype, jax compute_dtype, torch compute_dtype, rtol)
    "f64": (np.float64, None, None, 1e-12),
    "f32": (np.float32, None, None, 1e-5),
    "bf16": (np.float32, jnp.bfloat16, torch.bfloat16, 1e-5),
    "c128": (np.complex128, None, None, 1e-12),
}


def close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.max(np.abs(want)))


def _pair(rng, name, m=64, n=48):
    dt, jcd, tcd, _ = CASES[name]
    blocks = []
    for _ in range(NBLK):
        b = rng.standard_normal((m, n))
        if np.issubdtype(dt, np.complexfloating):
            b = b + 1j * rng.standard_normal((m, n))
        if jcd is not None:  # on the bf16 grid: both store the same values
            b = torch.from_numpy(b).to(torch.bfloat16).double().numpy()
        blocks.append(b.astype(dt))
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks], compute_dtype=jcd)
    top = pmtt.convert.blockdiag_from_numpy(
        [np.asarray(op.A) for op in jop.ops], compute_dtype=tcd, device="cpu")
    return jop, top


def _vec(rng, n, dt):
    v = rng.standard_normal(n)
    if np.issubdtype(dt, np.complexfloating):
        v = v + 1j * rng.standard_normal(n)
    return v.astype(dt)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matvec_rmatvec(rng, name):
    dt, _, _, rtol = CASES[name]
    jop, top = _pair(rng, name)
    assert top.shape == jop.shape and top._batched is not None
    x, y = _vec(rng, jop.shape[1], dt), _vec(rng, jop.shape[0], dt)
    tx = pmtt.DistributedArray.to_dist(x, device="cpu")
    ty = pmtt.DistributedArray.to_dist(y, device="cpu")
    jy, ty_ = jop.matvec(pmt.DistributedArray.to_dist(x)), top.matvec(tx)
    assert ty_.dtype == torch.from_numpy(np.asarray(jy.asarray())).dtype
    close(ty_.asarray(), jy.asarray(), rtol)
    close(top.rmatvec(ty).asarray(),
          jop.rmatvec(pmt.DistributedArray.to_dist(y)).asarray(), rtol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_normal_matvec(rng, name, monkeypatch):
    dt, _, _, rtol = CASES[name]
    jop, top = _pair(rng, name)
    calls = []
    real = nk.normal_matvec
    monkeypatch.setattr(nk, "normal_matvec",
                        lambda A, X: calls.append(1) or real(A, X))
    x = _vec(rng, jop.shape[1], dt)
    ju, jq = jop.normal_matvec(pmt.DistributedArray.to_dist(x))
    tu, tq = top.normal_matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    close(tq.asarray(), jq.asarray(), rtol)
    close(tu.asarray(), ju.asarray(), rtol)
    # real blocks go through the normal-product wrapper, complex ones take
    # the two-sweep product, as on the TPU
    fused = name != "c128"
    assert top.has_fused_normal == fused
    assert len(calls) == (1 if fused else 0)


def test_normal_matvec_dispatch_by_vector(rng, monkeypatch):
    _, top = _pair(rng, "f64")
    monkeypatch.setattr(nk, "normal_matvec",
                        lambda A, X: pytest.fail("kernel path taken"))
    n = top.shape[1]
    # complex vector and block (2-D) vector: two-sweep
    xc = pmtt.DistributedArray.to_dist(_vec(rng, n, np.complex128),
                                       device="cpu")
    u, q = top.normal_matvec(xc)
    close(u.asarray(), top.rmatvec(top.matvec(xc)).asarray(), 1e-12)
    xb = pmtt.DistributedArray.to_dist(rng.standard_normal((n, 3)),
                                       device="cpu")
    u, q = top.normal_matvec(xb)
    assert u.global_shape == (n, 3)


def test_block_vectors_match_jax(rng):
    jop, top = _pair(rng, "f64")
    X = rng.standard_normal((jop.shape[1], 3))
    close(top.matvec(pmtt.DistributedArray.to_dist(X, device="cpu")).asarray(),
          jop.matvec(pmt.DistributedArray.to_dist(X)).asarray(), 1e-12)


def test_otherdims_batched(rng):
    blocks = [rng.standard_normal((6, 4)) for _ in range(NBLK)]
    jop = pmt.MPIBlockDiag([JMatrixMult(b, otherdims=(3,)) for b in blocks])
    top = pmtt.MPIBlockDiag([TMatrixMult(torch.from_numpy(b), otherdims=(3,))
                             for b in blocks])
    assert top._batched_k == 3 and not top.has_fused_normal
    x = rng.standard_normal(jop.shape[1])
    close(top.matvec(pmtt.DistributedArray.to_dist(x, device="cpu")).asarray(),
          jop.matvec(pmt.DistributedArray.to_dist(x)).asarray(), 1e-12)
    y = rng.standard_normal(jop.shape[0])
    close(top.rmatvec(pmtt.DistributedArray.to_dist(y, device="cpu")).asarray(),
          jop.rmatvec(pmt.DistributedArray.to_dist(y)).asarray(), 1e-12)
    assert pmtt.dottest(top, device="cpu")


def test_heterogeneous_blocks(rng):
    shapes = [(5, 3), (4, 4), (6, 2), (3, 5), (5, 3), (2, 2), (4, 3), (3, 3)]
    blocks = [rng.standard_normal(s) for s in shapes]
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks])
    top = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
    assert top._batched is None and not top.has_fused_normal
    x = rng.standard_normal(jop.shape[1])
    close(top.matvec(pmtt.DistributedArray.to_dist(x, device="cpu")).asarray(),
          jop.matvec(pmt.DistributedArray.to_dist(x)).asarray(), 1e-12)
    u, q = top.normal_matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    ju, jq = jop.normal_matvec(pmt.DistributedArray.to_dist(x))
    close(u.asarray(), ju.asarray(), 1e-12)
    X = rng.standard_normal((jop.shape[1], 2))
    close(top.matvec(pmtt.DistributedArray.to_dist(X, device="cpu")).asarray(),
          jop.matvec(pmt.DistributedArray.to_dist(X)).asarray(), 1e-12)
    assert pmtt.dottest(top, device="cpu")


@pytest.mark.parametrize("name", sorted(CASES))
def test_dottest(rng, name):
    _, top = _pair(rng, name)
    cflag = 3 if name == "c128" else 0
    rtol = 1e-10 if name in ("f64", "c128") else 1e-4
    assert pmtt.dottest(top, complexflag=cflag, rtol=rtol, device="cpu")


def test_precision_policy_and_complex_guard(rng):
    from pylops_mpi_tpu_torch.ops import _precision
    blocks = [rng.standard_normal((4, 4)).astype(np.float32)
              for _ in range(NBLK)]
    try:
        _precision.set_precision("bf16")
        top = pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")
        assert top._batched.dtype == torch.bfloat16
        f64 = pmtt.convert.blockdiag_from_numpy(blocks, dtype=np.float64,
                                                device="cpu")
        assert f64._batched.dtype == torch.float64  # f64 never narrows
    finally:
        _precision.set_precision(None)
    with pytest.raises(ValueError, match="imaginary"):
        pmtt.convert.blockdiag_from_numpy(
            [b.astype(np.complex64) for b in blocks],
            compute_dtype=torch.bfloat16, device="cpu")
