"""The tap stencil ``y[j] = Σ_d c_d · slab[w + j + d]`` along axis 0.

Counterpart of the stencil half of ``pylops_mpi_tpu/ops/pallas_kernels.py``
(``_taps_kernel`` through ``stencil_taps``, and the centered-3
conveniences ``first_derivative_centered``/``second_derivative`` through
``_centered3``). On a CUDA tensor :func:`stencil_taps` launches the
hand-written Hopper kernel ``csrc/stencil_taps.cu``; on a CPU tensor it
computes :func:`stencil_taps_plain`, the same function in plain PyTorch.
A build or launch failure raises: nothing falls back.

The slab may come in up to three pieces, ``[top; slab; bottom]``, where
``top`` and ``bottom`` are either tensors of ghost rows (a neighbour's
boundary rows) or a count of zero rows. The derivative operators pass
the field itself as the middle piece and zero counts around it, so no
padded copy of the field is ever made.

Dtype rules (both versions): any floating dtype; bf16/f16 slabs
accumulate in f32 and f32 slabs in f32, f64 slabs in f64; the output is
rounded once to the slab's dtype. The kernel takes f32, f64, bf16 and
f16, at most 2 halo rows (``w ≤ 2``) and distinct tap offsets.

Gradients: under grad mode, when the slab or a ghost piece requires
grad, :func:`stencil_taps` runs as an ``autograd.Function`` whose
backward is the transposed stencil through the same launch: the
cotangent's ``rows`` core, with taps ``(-d, c_d)`` and ``2w`` zero rows
given as the ``top``/``bottom`` counts, is the cotangent of the whole
``rows + 2w`` slab, sliced back into ``top``, ``slab`` and ``bottom``
(the ghost pieces' cotangents go home through
:func:`~..parallel.collectives.halo_exchange`'s backward). On the card
that is one more launch of ``csrc/stencil_taps.cu``, counted in
``launches_bwd``; on the CPU both directions take the plain version.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Tuple, Union

import torch

from . import _build
from ._precision import accum_dtype

__all__ = ["stencil_taps", "stencil_taps_plain", "first_derivative_centered",
           "second_derivative", "launches", "launches_bwd", "reset_launches"]

# Kernel launches since the last reset_launches(), of the forward stencil
# and of the transposed one in a backward pass; a run reads them to show
# that its operators went through the kernel.
launches = 0
launches_bwd = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_MAX_W = 2
# rows of output each CTA walks down; a multiple of the kernel's 4-row
# unroll, raised for slabs so tall that the grid's y extent would pass
# 65535
_RUN = 64
_MAX_GRID_Y = 65535

_FN = None

Piece = Union[int, torch.Tensor]


def reset_launches() -> None:
    global launches, launches_bwd
    launches = launches_bwd = 0


def _piece_rows(p: Piece) -> int:
    return int(p.shape[0]) if isinstance(p, torch.Tensor) else int(p)


def _check(slab: torch.Tensor, taps, w: int, out_pad, top: Piece,
           bottom: Piece) -> Tuple[Tuple[Tuple[int, float], ...], int, int]:
    """Validate the call; returns ``(taps, rows, cols)``."""
    taps = tuple((int(d), float(c)) for d, c in taps)
    if not taps:
        raise ValueError("stencil_taps needs at least one tap")
    if any(abs(d) > w for d, _ in taps):
        raise ValueError(f"tap offsets {[d for d, _ in taps]} exceed the "
                         f"halo width w={w}")
    if min(out_pad) < 0:
        raise ValueError(f"out_pad must be non-negative, got {out_pad}")
    if slab.ndim == 0:
        raise ValueError("stencil_taps needs a slab of at least one axis")
    for name, p in (("top", top), ("bottom", bottom)):
        if isinstance(p, torch.Tensor):
            if p.shape[1:] != slab.shape[1:]:
                raise ValueError(f"{name} ghost rows {tuple(p.shape)} do not "
                                 f"match the slab's trailing shape "
                                 f"{tuple(slab.shape[1:])}")
            if p.dtype != slab.dtype or p.device != slab.device:
                raise ValueError(f"{name} ghost rows are {p.dtype} on "
                                 f"{p.device}, the slab {slab.dtype} on "
                                 f"{slab.device}")
        elif int(p) < 0:
            raise ValueError(f"{name} must be a tensor or a row count >= 0")
    total = _piece_rows(top) + int(slab.shape[0]) + _piece_rows(bottom)
    rows = total - 2 * w
    if rows < 0:
        raise ValueError(f"a slab of {total} rows is shorter than the halo "
                         f"2w={2 * w}")
    return taps, rows, math.prod(slab.shape[1:])


def stencil_taps_plain(slab: torch.Tensor, taps, w: int,
                       out_pad=(0, 0), *, top: Piece = 0,
                       bottom: Piece = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`stencil_taps`: the pieces joined
    into one slab, each tap a shifted slice, summed in the accumulation
    dtype and rounded once."""
    taps, rows, _ = _check(slab, taps, w, out_pad, top, bottom)
    parts = []
    for p in (top, slab, bottom):
        if isinstance(p, torch.Tensor):
            parts.append(p)
        elif p:
            parts.append(slab.new_zeros((p,) + tuple(slab.shape[1:])))
    full = torch.cat(parts) if len(parts) > 1 else slab
    acc = accum_dtype(full.dtype)
    y = None
    for d, c in taps:
        part = full[w + d: w + d + rows].to(acc) * c
        y = part if y is None else y + part
    y = y.to(slab.dtype)
    lo, hi = int(out_pad[0]), int(out_pad[1])
    if lo or hi:
        y = torch.cat([y.new_zeros((lo,) + tuple(y.shape[1:])), y,
                       y.new_zeros((hi,) + tuple(y.shape[1:]))])
    return y


def _kernel_fn():
    global _FN
    if _FN is None:
        lib = _build.load("stencil_taps")
        fn = lib.stencil_taps_launch
        fn.argtypes = ([ctypes.c_int] * 3
                       + [ctypes.c_void_p, ctypes.c_int64] * 3
                       + [ctypes.c_void_p] + [ctypes.c_int64] * 2
                       + [ctypes.c_int64] * 2
                       + [ctypes.POINTER(ctypes.c_double), ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.stencil_taps_error_string.argtypes = [ctypes.c_int]
        lib.stencil_taps_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.stencil_taps_error_string)
    return _FN


def stencil_taps(slab: torch.Tensor, taps: Sequence[Tuple[int, float]],
                 w: int, out_pad=(0, 0), *, top: Piece = 0,
                 bottom: Piece = 0) -> torch.Tensor:
    """Apply the tap stencil to the slab ``[top; slab; bottom]`` of
    ``rows + 2w`` rows (any trailing shape): ``(pad_lo + rows + pad_hi,
    …)`` with ``out_pad`` zero rows written in the same pass.

    ``taps`` is a sequence of ``(offset, coefficient)`` with
    ``|offset| <= w``. ``top``/``bottom`` are ghost-row tensors or counts
    of zero rows (default: none, the JAX package's contract). A CUDA
    slab launches ``csrc/stencil_taps.cu`` on the current stream; a CPU
    slab takes :func:`stencil_taps_plain`. Under grad mode, with a piece
    that requires grad, the call is differentiable (module docstring)."""
    if torch.is_grad_enabled() and any(
            isinstance(p, torch.Tensor) and p.requires_grad
            for p in (slab, top, bottom)):
        taps = tuple((int(d), float(c)) for d, c in taps)
        return _Taps.apply(slab, top, bottom, taps, int(w),
                           (int(out_pad[0]), int(out_pad[1])))
    return _launch(slab, taps, w, out_pad, top, bottom)


class _Taps(torch.autograd.Function):
    """The tap stencil with its transposed stencil as the backward, both
    through :func:`_launch` (module docstring)."""

    @staticmethod
    def forward(ctx, slab, top, bottom, taps, w, out_pad):
        ctx.meta = (taps, w, out_pad, _piece_rows(top), int(slab.shape[0]))
        return _launch(slab, taps, w, out_pad, top, bottom)

    @staticmethod
    def backward(ctx, g):
        taps, w, (lo, hi), ntop, nslab = ctx.meta
        rows = g.shape[0] - lo - hi
        core = g.narrow(0, lo, rows).contiguous()
        full = _launch(core, tuple((-d, c) for d, c in taps), w, (0, 0),
                       2 * w, 2 * w, backward=True)
        gtop = full[:ntop] if ctx.needs_input_grad[1] else None
        gslab = full[ntop:ntop + nslab] if ctx.needs_input_grad[0] else None
        gbot = full[ntop + nslab:] if ctx.needs_input_grad[2] else None
        return gslab, gtop, gbot, None, None, None


def _launch(slab: torch.Tensor, taps, w: int, out_pad, top: Piece,
            bottom: Piece, backward: bool = False) -> torch.Tensor:
    """One stencil pass, not differentiated: the kernel for a CUDA slab
    (counted in ``launches``, or ``launches_bwd`` for a backward pass),
    the plain version for a CPU one."""
    if slab.device.type == "cpu":
        return stencil_taps_plain(slab, taps, w, out_pad, top=top,
                                  bottom=bottom)
    taps, rows, cols = _check(slab, taps, w, out_pad, top, bottom)
    if slab.device.type != "cuda":
        raise ValueError(f"stencil_taps runs on CUDA or CPU tensors, got "
                         f"{slab.device}")
    if slab.dtype not in _DTYPE_CODES:
        raise ValueError(f"the stencil kernel takes float32, float64, "
                         f"bfloat16 or float16 slabs, got {slab.dtype}")
    if not 1 <= w <= _MAX_W:
        raise ValueError(f"the stencil kernel takes halo widths 1..{_MAX_W}, "
                         f"got w={w}")
    offsets = [d for d, _ in taps]
    if len(set(offsets)) != len(offsets):
        raise ValueError(f"the stencil kernel takes distinct tap offsets, "
                         f"got {offsets}")
    pieces = [(p if isinstance(p, torch.Tensor) else None, _piece_rows(p))
              for p in (top, slab, bottom)]
    if any(t is not None and not t.is_contiguous() for t, _ in pieces):
        raise ValueError("stencil_taps needs contiguous slab and ghost rows")
    lo, hi = int(out_pad[0]), int(out_pad[1])
    out = torch.empty((lo + rows + hi,) + tuple(slab.shape[1:]),
                      dtype=slab.dtype, device=slab.device)
    if out.numel() == 0:
        return out
    coeff = (ctypes.c_double * (2 * w + 1))()
    present = 0
    for d, c in taps:
        coeff[d + w] = c
        present |= 1 << (d + w)
    # 16-byte vectors of columns where every row of every piece starts on
    # a 16-byte boundary; one column per thread otherwise
    vec = 16 // slab.element_size()
    wide = cols % vec == 0 and all(
        t.data_ptr() % 16 == 0 for t in [out] + [t for t, _ in pieces
                                                  if t is not None])
    run = max(_RUN, math.ceil(max(rows, 1) / _MAX_GRID_Y / 4) * 4)
    fn, errstr = _kernel_fn()
    dev = slab.device.index if slab.device.index is not None \
        else torch.cuda.current_device()
    args = []
    for t, n in pieces:
        args += [0 if t is None else t.data_ptr(), n]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODES[slab.dtype], w, vec if wide else 1, *args,
                 out.data_ptr(), cols, rows, lo, hi, coeff, present, run,
                 stream)
    if err != 0:
        raise RuntimeError(f"stencil_taps kernel launch failed: error {err} "
                           f"({errstr(err).decode()})")
    global launches, launches_bwd
    if backward:
        launches_bwd += 1
    else:
        launches += 1
    return out


def _centered3(x: torch.Tensor, axis: int, taps) -> torch.Tensor:
    """One :func:`stencil_taps` pass on the moved/flattened array, edge
    rows zeroed in the same pass (pylops ``edge=False``), layout
    restored."""
    v = torch.movedim(x, axis, 0)
    shp = v.shape
    if shp[0] < 3:  # too short for the 3-point core: all edge rows
        return torch.zeros_like(x)
    y = stencil_taps(v.reshape(shp[0], -1), taps, 1, out_pad=(1, 1))
    return torch.movedim(y.reshape(shp), 0, axis)


def first_derivative_centered(x: torch.Tensor, axis: int = 0,
                              sampling: float = 1.0) -> torch.Tensor:
    """Centered 3-point first derivative along ``axis`` (edge rows zero,
    pylops ``edge=False``), as one stencil pass."""
    c = 1.0 / (2.0 * sampling)
    return _centered3(x, axis, ((-1, -c), (1, c)))


def second_derivative(x: torch.Tensor, axis: int = 0,
                      sampling: float = 1.0) -> torch.Tensor:
    """3-point second derivative along ``axis`` as one stencil pass."""
    c = 1.0 / sampling ** 2
    return _centered3(x, axis, ((-1, c), (0, -2.0 * c), (1, c)))
