"""pylops_mpi_tpu_torch.DistributedArray held against
pylops_mpi_tpu.DistributedArray: the same numpy inputs through both.

Tolerance: float64 throughout, rtol 1e-12 (the two sum in different
orders; 1e-12 leaves room for that and nothing else). The bf16 case
holds the f32 accumulation of narrow vectors to rtol 1e-5.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.parallel import mesh as tmesh

RTOL = 1e-12
CPU = "cpu"


def _pair(x):
    return (pmt.DistributedArray.to_dist(x),
            pmtt.DistributedArray.to_dist(x, device=CPU))


@pytest.mark.parametrize("cmplx", [False, True])
@pytest.mark.parametrize("vdot", [False, True])
def test_dot(rng, cmplx, vdot):
    a = rng.standard_normal(37) + (1j * rng.standard_normal(37) if cmplx else 0)
    b = rng.standard_normal(37) + (1j * rng.standard_normal(37) if cmplx else 0)
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    want = np.asarray(ja.dot(jb, vdot=vdot))
    got = ta.dot(tb, vdot=vdot)
    assert got.ndim == 0 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("ord", [None, 1, 2, np.inf, -np.inf, 0, 3])
@pytest.mark.parametrize("cmplx", [False, True])
def test_norm(rng, ord, cmplx):
    a = rng.standard_normal(41) + (1j * rng.standard_normal(41) if cmplx else 0)
    a[3] = 0
    ja, ta = _pair(a)
    want = np.asarray(ja.norm(ord=ord))
    got = ta.norm(ord=ord)
    assert got.ndim == 0
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_norm_axis(rng):
    a = rng.standard_normal((6, 5))
    ja, ta = _pair(a)
    np.testing.assert_allclose(ta.norm(axis=1).numpy(),
                               np.asarray(ja.norm(axis=1)), rtol=RTOL)
    with pytest.raises(ValueError):
        ta.norm(axis=2)


def test_arithmetic(rng):
    a, b = rng.standard_normal(29), rng.standard_normal(29) + 3.0
    ja, ta = _pair(a)
    jb, tb = _pair(b)
    cases = [(ja + jb, ta + tb), (ja - jb, ta - tb), (ja * jb, ta * tb),
             (ja / jb, ta / tb), (-ja, -ta), (ja * 2.5, ta * 2.5),
             (2.5 * ja, 2.5 * ta), (ja.conj(), ta.conj()),
             (ja.copy(), ta.copy()), (ja.zeros_like(), ta.zeros_like())]
    for j, t in cases:
        np.testing.assert_allclose(t.asarray(), j.asarray(), rtol=RTOL)
    ta2 = ta.copy()
    ta2 += tb
    ta2 -= 0.5 * tb
    np.testing.assert_allclose(ta2.asarray(), a + 0.5 * b, rtol=RTOL)
    np.testing.assert_allclose(ta.asarray(), a, rtol=0)  # copy untouched


def test_layout_metadata(rng):
    x = rng.standard_normal((10, 4))
    for axis in (0, 1):
        j = pmt.DistributedArray.to_dist(x, axis=axis)
        t = pmtt.DistributedArray.to_dist(x, axis=axis, device=CPU)
        assert t.global_shape == j.global_shape
        assert t.axis == j.axis and t.partition.name == j.partition.name
        # one worker: the port's local split is the JAX split at P=1
        assert t.local_shapes == pmtt.local_split(x.shape, 1,
                                                  pmtt.Partition.SCATTER, axis)
        assert t.local_shapes == (x.shape,)
    with pytest.raises(ValueError, match="Global shape mismatch"):
        pmtt.DistributedArray.to_dist(np.ones(3), device=CPU) + \
            pmtt.DistributedArray.to_dist(np.ones(4), device=CPU)
    with pytest.raises(ValueError, match="Partition mismatch"):
        pmtt.DistributedArray.to_dist(np.ones(3), device=CPU) + \
            pmtt.DistributedArray.to_dist(
                np.ones(3), partition=pmtt.Partition.BROADCAST, device=CPU)


def test_local_split_matches_reference():
    from pylops_mpi_tpu.parallel.partition import local_split as jsplit
    for shape, p, axis in [((10,), 3, 0), ((7, 5), 4, 1), ((9, 2), 2, 0)]:
        for part in ("SCATTER", "BROADCAST"):
            assert pmtt.local_split(shape, p, pmtt.Partition[part], axis) == \
                jsplit(shape, p, pmt.Partition[part], axis)


def test_bf16_vectors_reduce_at_f32(rng):
    a = rng.standard_normal(300).astype(np.float32)
    ja = pmt.DistributedArray.to_dist(jnp.asarray(a, dtype=jnp.bfloat16))
    ta = pmtt.DistributedArray.to_dist(torch.from_numpy(a).to(torch.bfloat16))
    got, want = ta.norm(), ja.norm()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(ta.dot(ta).numpy(), np.asarray(ja.dot(ja)),
                               rtol=1e-5)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tmesh.default_device().type == "cuda"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmtt.DistributedArray.to_dist(np.ones(4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmtt.DistributedArray(global_shape=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmtt.convert.blockdiag_from_numpy([np.eye(3)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pmtt.ops.local.MatrixMult(np.eye(3))
    # an explicit CPU request works
    assert pmtt.DistributedArray.to_dist(np.ones(4), device=CPU).device.type \
        == "cpu"


def test_import_pulls_in_no_jax():
    code = ("import sys, pylops_mpi_tpu_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'pylops_mpi_tpu' or m.startswith('pylops_mpi_tpu.')]\n"
            "print(bad)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_import_pins_full_f32_products():
    # the JAX package pins jax_default_matmul_precision=highest
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
