"""The yardstick's arithmetic: the card's published peaks and the least
bytes and operations of each measured range, computed from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM (dense rates, 700 W).
A range's bound counts each input byte read once and each output byte
written once, whatever the code under test reads again; the roofline share
of a range is that bound's time over the device time the range took.
"""

from __future__ import annotations

from dataclasses import dataclass

# H100 SXM, NVIDIA data sheet
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "f32_flops": 67e12,
    "f64_flops": 34e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
}


@dataclass(frozen=True)
class Bound:
    """Least bytes and floating-point operations of one call."""
    nbytes: float
    flops: float = 0.0
    flops_peak: str = "f32_flops"

    def seconds(self) -> float:
        """The larger of the byte time and the operation time."""
        t_bytes = self.nbytes / PEAKS["hbm_bytes_per_s"]
        t_ops = self.flops / PEAKS[self.flops_peak]
        return max(t_bytes, t_ops)


def normal_apply(nblk: int, m: int, n: int, itemsize: int = 4) -> Bound:
    """``(u, q) = (AᴴA x, A x)`` over ``nblk`` blocks of ``m × n``: A read
    once, x read, u and q written; 4·m·n operations a block."""
    nbytes = nblk * m * n * itemsize + nblk * (2 * n + m) * itemsize
    return Bound(float(nbytes), 4.0 * nblk * m * n)


def blockdiag_apply(nblk: int, m: int, n: int, itemsize: int = 4) -> Bound:
    """One forward (or adjoint) apply of ``nblk`` blocks of ``m × n``: A
    read once, the input read, the output written; 2·m·n operations a
    block."""
    nbytes = nblk * m * n * itemsize + nblk * (m + n) * itemsize
    return Bound(float(nbytes), 2.0 * nblk * m * n)


def poststack_apply(npoints: int, itemsize: int = 4) -> Bound:
    """One forward (or adjoint) apply of ``[W·D; ε·∇]`` on a model of
    ``npoints`` samples in two dimensions: the model read once and the
    three outputs (data, two gradient components) written once, or the
    reverse. The operations (a short convolution and differences) are far
    below the byte time and are not counted."""
    return Bound(float(4 * npoints * itemsize))
