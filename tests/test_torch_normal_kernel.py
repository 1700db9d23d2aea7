"""The port's normal product ``(AᵀA x, A x)`` held against the JAX
package's Pallas kernel ``batched_normal_matvec``, run as
tests/test_pallas.py runs it (interpret mode on the CPU).

Tolerances, relative to the largest entry of the reference (entries
that cancel are held to the same absolute error as the rest):
- f32 blocks: rtol 1e-5 (two f32 sums in different orders);
- bf16 / f16 storage with an f32 x: rtol 1e-5 (both sides widen the same
  narrow values and accumulate in f32);
- f64 blocks: rtol 1e-12.
The kernel itself runs only on the card: the ``cuda``-marked test holds
it to the plain version there and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pylops_mpi_tpu.ops.pallas_kernels import batched_normal_matvec
from pylops_mpi_tpu_torch.ops import normal_kernels as nk

CASES = {  # name: (torch storage, jax storage, x dtype, rtol)
    "f32": (torch.float32, jnp.float32, np.float32, 1e-5),
    "bf16": (torch.bfloat16, jnp.bfloat16, np.float32, 1e-5),
    "f16": (torch.float16, jnp.float16, np.float32, 1e-5),
    "f64": (torch.float64, jnp.float64, np.float64, 1e-12),
}


def close(got, want, rtol):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _inputs(rng, nblk, m, n, tdt, xdt):
    # values on the narrow grid, so both packages store the same numbers
    A = rng.standard_normal((nblk, m, n)).astype(np.float32)
    A = torch.from_numpy(A).to(tdt).to(torch.float64).numpy()
    X = rng.standard_normal((nblk, n)).astype(xdt)
    return A, X


@pytest.mark.parametrize("shape", [(8, 64, 48), (8, 40, 24), (3, 16, 33)])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_matches_pallas(rng, name, shape):
    tdt, jdt, xdt, rtol = CASES[name]
    A, X = _inputs(rng, *shape, tdt, xdt)
    uj, qj = batched_normal_matvec(jnp.asarray(A, dtype=jdt), jnp.asarray(X))
    At, Xt = torch.from_numpy(A).to(tdt), torch.from_numpy(X)
    ut, qt = nk.normal_matvec_plain(At, Xt)
    assert ut.dtype == Xt.dtype and qt.dtype == Xt.dtype
    assert np.asarray(uj).dtype == X.dtype
    close(qt.numpy(), qj, rtol)
    close(ut.numpy(), uj, rtol)


def test_wrapper_takes_plain_version_on_cpu(rng):
    A, X = _inputs(rng, 2, 9, 7, torch.float32, np.float32)
    At, Xt = torch.from_numpy(A).float(), torch.from_numpy(X)
    nk.reset_launches()
    u, q = nk.normal_matvec(At, Xt)
    u2, q2 = nk.normal_matvec_plain(At, Xt)
    assert torch.equal(u, u2) and torch.equal(q, q2)
    assert nk.launches == 0  # the kernel never ran


@pytest.mark.parametrize("A_shape,X_shape,adt,xdt,match", [
    ((2, 3, 4), (2, 5), torch.float32, torch.float32, "does not match"),
    ((3, 4), (3, 4), torch.float32, torch.float32, "nblk, m, n"),
    ((2, 3, 4), (2, 4), torch.bfloat16, torch.bfloat16, "float32"),
    ((2, 3, 4), (2, 4), torch.float32, torch.float64, "float32"),
    ((2, 3, 4), (2, 4), torch.complex64, torch.complex64, "float32"),
])
def test_wrapper_rejects(A_shape, X_shape, adt, xdt, match):
    with pytest.raises(ValueError, match=match):
        nk.normal_matvec(torch.zeros(A_shape, dtype=adt),
                         torch.zeros(X_shape, dtype=xdt))


def test_tile_plan():
    # two CTAs per SM at the main path's width; ragged last tile at f32
    tm, off, smem = nk._tile_rows(4096, torch.float32)
    assert (tm, smem <= nk._SMEM_TWO_CTAS) == (5, True)
    assert off % 16 == 0 and off >= 2 * 4096 * 4 + tm * 4
    assert nk._tile_rows(4096, torch.bfloat16)[0] == 10
    assert nk._tile_rows(4096, torch.float64)[0] == 1
    # too wide for shared memory: unsupported, so the caller goes two-sweep
    assert nk._tile_rows(30000, torch.float32) is None
    assert not nk.supported(torch.float32, torch.float32, 30000)
    assert nk.supported(torch.bfloat16, torch.float32, 4096)
    assert not nk.supported(torch.bfloat16, torch.bfloat16, 4096)
    assert not nk.supported(torch.complex128, torch.complex128, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["f32", "bf16", "f16", "f64"])
def test_kernel_matches_plain_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    tdt, _, xdt, _ = CASES[name]
    g = torch.Generator(device="cuda").manual_seed(0)
    A = torch.randn((3, 1000, 777), generator=g, device="cuda").to(tdt)
    X = torch.randn((3, 777), generator=g, device="cuda",
                    dtype=torch.float64 if tdt == torch.float64
                    else torch.float32)
    nk.reset_launches()
    u, q = nk.normal_matvec(A, X)
    torch.cuda.synchronize()
    assert nk.launches == 1
    u2, q2 = nk.normal_matvec_plain(A, X)
    tol = 1e-12 if tdt == torch.float64 else 1e-4
    for got, want in ((u, u2), (q, q2)):
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= tol


def test_build_needs_nvcc_and_keys_on_sources(tmp_path, monkeypatch):
    from pylops_mpi_tpu_torch.ops import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if _build.Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("a CUDA toolkit is installed here")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
    target = _build._target("normal_matvec")
    assert target.parent == _build.BUILD_DIR
    assert target.name.startswith("libnormal_matvec-") and \
        target.suffix == ".so"
