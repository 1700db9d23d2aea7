"""The port's tap stencil held against the JAX package's Pallas kernel
``stencil_taps`` (run as tests/test_pallas.py runs it: interpret mode on
the CPU) and its centered-3 conveniences.

Every tap set the explicit derivative path emits (``_stencil_spec``),
forward and offset-reversed (the adjoint), with and without ``out_pad``,
on ragged column counts and trailing dims. Tolerances, relative to the
largest entry of the reference: float32 rtol 1e-6 (both sum the same
f32 products in different orders), float64 rtol 1e-12. The kernel
itself runs only on the card: the ``cuda``-marked test holds it to the
plain version there and skips without one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pylops_mpi_tpu.ops import pallas_kernels as pk
from pylops_mpi_tpu_torch.ops import stencil_kernels as sk

RTOL = {np.float32: 1e-6, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}

# name: (taps as offset -> coefficient, halo width w), from _stencil_spec
TAP_SETS = {
    "first_forward": ({1: 1 / 0.7, 0: -1 / 0.7}, 1),
    "first_backward": ({0: 1 / 0.7, -1: -1 / 0.7}, 1),
    "first_centered3": ({1: 0.5 / 0.7, -1: -0.5 / 0.7}, 1),
    "first_centered5": ({-2: 1 / 12, -1: -8 / 12, 1: 8 / 12, 2: -1 / 12}, 2),
    "second_forward": ({0: 1.0, 1: -2.0, 2: 1.0}, 2),
    "second_backward": ({0: 1.0, -1: -2.0, -2: 1.0}, 2),
    "second_centered": ({-1: 1 / 0.49, 0: -2 / 0.49, 1: 1 / 0.49}, 1),
}
# (interior rows, trailing shape, out_pad)
LAYOUTS = [(40, (12,), (0, 0)), (33, (5, 3), (2, 1)), (17, (), (1, 1))]


def close(got, want, rtol):
    want = np.asarray(want, dtype=np.float64)
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64), want,
                               rtol=rtol, atol=rtol * np.max(np.abs(want)))


def _taps(name, reverse):
    taps, w = TAP_SETS[name]
    return tuple((-d if reverse else d, c) for d, c in taps.items()), w


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", sorted(TAP_SETS))
def test_plain_matches_pallas(rng, name, reverse, dtype, layout):
    taps, w = _taps(name, reverse)
    rows, trail, pad = LAYOUTS[layout]
    slab = rng.standard_normal((rows + 2 * w,) + trail).astype(dtype)
    want = np.asarray(pk.stencil_taps(jnp.asarray(slab), taps, w,
                                      out_pad=pad))
    got = sk.stencil_taps_plain(torch.from_numpy(slab), taps, w, out_pad=pad)
    assert got.dtype == TORCH[dtype]
    assert tuple(got.shape) == want.shape == (pad[0] + rows + pad[1],) + trail
    close(got.numpy(), want, RTOL[dtype])
    np.testing.assert_array_equal(got.numpy()[:pad[0]], 0.0)
    np.testing.assert_array_equal(got.numpy()[pad[0] + rows:], 0.0)


@pytest.mark.parametrize("name", ["first_centered5", "second_centered"])
def test_three_piece_slab_matches_joined_slab(rng, name):
    """``[top; body; bottom]`` with ghost tensors or zero-row counts is
    the stencil of the joined slab."""
    taps, w = _taps(name, False)
    body = rng.standard_normal((30, 7))
    ghost = rng.standard_normal((w, 7))
    for top, bottom in [(ghost, 0), (0, ghost), (w + 1, w), (ghost, 2 * w)]:
        parts = [p if isinstance(p, np.ndarray) else np.zeros((p, 7))
                 for p in (top, body, bottom)]
        want = np.asarray(pk.stencil_taps(jnp.asarray(np.concatenate(parts)),
                                          taps, w, out_pad=(1, 2)))
        got = sk.stencil_taps(
            torch.from_numpy(body), taps, w, out_pad=(1, 2),
            top=torch.from_numpy(top) if isinstance(top, np.ndarray) else top,
            bottom=(torch.from_numpy(bottom) if isinstance(bottom, np.ndarray)
                    else bottom))
        close(got.numpy(), want, RTOL[np.float64])


@pytest.mark.parametrize("n", [1, 2, 3, 16])
@pytest.mark.parametrize("axis", [0, 1])
def test_centered3_conveniences(rng, n, axis):
    shape = (n, 6) if axis == 0 else (5, n)
    x = rng.standard_normal(shape)
    for jfn, tfn, s in ((pk.first_derivative_centered,
                         sk.first_derivative_centered, 0.5),
                        (pk.second_derivative, sk.second_derivative, 2.0)):
        want = np.asarray(jfn(jnp.asarray(x), axis=axis, sampling=s))
        got = tfn(torch.from_numpy(x), axis=axis, sampling=s)
        assert tuple(got.shape) == shape
        if n < 3:
            np.testing.assert_array_equal(got.numpy(), 0.0)
        close(got.numpy(), want, RTOL[np.float64])


def test_bf16_plain_rounds_once(rng):
    """Narrow slabs accumulate at f32 and round once, as the kernel
    does: the result is the f32 stencil of the same values, rounded."""
    x = torch.from_numpy(rng.standard_normal((20, 9)).astype(np.float32))
    xb = x.to(torch.bfloat16)
    taps, w = _taps("first_centered5", False)
    got = sk.stencil_taps_plain(xb, taps, w)
    assert got.dtype == torch.bfloat16
    want = sk.stencil_taps_plain(xb.float(), taps, w).to(torch.bfloat16)
    assert torch.equal(got, want)


def test_wrapper_takes_plain_version_on_cpu(rng):
    slab = torch.from_numpy(rng.standard_normal((14, 5)))
    taps, w = _taps("second_forward", True)
    sk.reset_launches()
    got = sk.stencil_taps(slab, taps, w, out_pad=(2, 0))
    assert torch.equal(got, sk.stencil_taps_plain(slab, taps, w,
                                                  out_pad=(2, 0)))
    assert sk.launches == 0  # the kernel never ran


@pytest.mark.parametrize("kwargs,match", [
    (dict(taps=((3, 1.0),), w=2), "exceed the halo"),
    (dict(taps=(), w=1), "at least one tap"),
    (dict(taps=((1, 1.0),), w=4), "shorter than the halo"),
    (dict(taps=((1, 1.0),), w=1, out_pad=(-1, 0)), "non-negative"),
    (dict(taps=((1, 1.0),), w=1, top=torch.zeros(1, 4)), "trailing shape"),
    (dict(taps=((1, 1.0),), w=1, bottom=torch.zeros(1, 3,
                                                     dtype=torch.float32)),
     "float32"),
    (dict(taps=((1, 1.0),), w=1, top=-1), "row count"),
])
def test_wrapper_rejects(kwargs, match):
    with pytest.raises(ValueError, match=match):
        sk.stencil_taps(torch.zeros(6, 3, dtype=torch.float64), **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(TAP_SETS))
def test_kernel_matches_plain_on_card(name, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    g = torch.Generator(device="cuda").manual_seed(0)
    for reverse in (False, True):
        taps, w = _taps(name, reverse)
        slab = torch.randn((1003 + 2 * w, 777), generator=g,
                           device="cuda").to(dtype)
        sk.reset_launches()
        got = sk.stencil_taps(slab, taps, w, out_pad=(2, 1))
        torch.cuda.synchronize()
        assert sk.launches == 1
        want = sk.stencil_taps_plain(slab, taps, w, out_pad=(2, 1))
        err = (got.double() - want.double()).abs().max() \
            / want.double().abs().max()
        assert float(err) <= tol
