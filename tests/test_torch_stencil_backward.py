"""The tap kernel's autograd rule on the card (``stencil_taps`` as an
``autograd.Function``: its backward is the same kernel on the transposed
taps). Card-only, so no JAX here: the kernel's gradient is held against
autograd through the plain PyTorch version.

Run on the card with ``python3 -m pytest -m cuda
tests/test_torch_stencil_backward.py``; skips without a CUDA device.
Tolerances as the test states.
"""

import pytest
import torch

from pylops_mpi_tpu_torch.ops import stencil_kernels as sk

# the tap sets the derivative operators emit (sampling 1)
TAP_SETS = {
    "first_forward": ({1: 1.0, 0: -1.0}, 1),
    "first_centered3": ({1: 0.5, -1: -0.5}, 1),
    "first_centered5": ({-2: 1 / 12, -1: -8 / 12, 1: 8 / 12, 2: -1 / 12}, 2),
    "second_forward": ({0: 1.0, 1: -2.0, 2: 1.0}, 2),
    "second_centered": ({-1: 1.0, 0: -2.0, 1: 1.0}, 1),
}


def _taps(name, reverse):
    taps, w = TAP_SETS[name]
    return tuple((-d if reverse else d, c) for d, c in taps.items()), w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.float64, 1e-12),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("name", sorted(TAP_SETS))
def test_kernel_backward_matches_plain_autograd_on_card(name, dtype, tol):
    """The autograd rule's backward (the kernel on the transposed taps)
    against autograd through the plain version, ghost pieces included;
    one backward launch a call. bf16 to 3e-2: the plain version's
    autograd rounds each tap's part to bf16 and adds in bf16 (a rounding
    a tap, up to 2^-7 of the largest entry each), the kernel rounds
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card, not here)")
    g = torch.Generator(device="cuda").manual_seed(1)
    taps, w = _taps(name, False)
    slab = torch.randn((1003, 777), generator=g, device="cuda").to(dtype)
    top = torch.randn((w, 777), generator=g, device="cuda").to(dtype)
    bottom = torch.randn((w, 777), generator=g, device="cuda").to(dtype)
    for t in (slab, top, bottom):
        t.requires_grad_(True)
    sk.reset_launches()
    y = sk.stencil_taps(slab, taps, w, out_pad=(2, 1), top=top,
                        bottom=bottom)
    gy = torch.randn(tuple(y.shape), generator=g, device="cuda").to(dtype)
    got = torch.autograd.grad(y, (slab, top, bottom), gy)
    torch.cuda.synchronize()
    assert (sk.launches, sk.launches_bwd) == (1, 1)
    yp = sk.stencil_taps_plain(slab, taps, w, out_pad=(2, 1), top=top,
                               bottom=bottom)
    want = torch.autograd.grad(yp, (slab, top, bottom), gy)
    for a, b in zip(got, want):
        # a one-sided tap set reads no row of one ghost: its gradient is
        # zero on both sides, and the error is then held absolutely
        scale = max(float(b.double().abs().max()), 1.0)
        err = (a.double() - b.double()).abs().max() / scale
        assert float(err) <= tol
