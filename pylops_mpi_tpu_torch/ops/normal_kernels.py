"""The one-sweep normal product ``(u, q) = (AᵀA x, A x)`` per block.

Counterpart of the normal-product half of
``pylops_mpi_tpu/ops/pallas_kernels.py`` (``_normal_kernel``,
``_normal_kernel_stream``, ``batched_normal_matvec``): the CGLS hot pair
from one read of each block. On a CUDA tensor :func:`normal_matvec`
launches the hand-written Hopper kernel ``csrc/normal_matvec.cu``; on a
CPU tensor it computes :func:`normal_matvec_plain`, the same function in
plain PyTorch. A build or launch failure raises: nothing falls back.

Dtype rules (both versions): A ``(nblk, m, n)`` is float32, or
bfloat16/float16 storage, with an f32 ``X (nblk, n)``, accumulating in
f32; or float64 with an f64 ``X``, accumulating in f64. ``u (nblk, n)``
and ``q (nblk, m)`` come back at X's dtype.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["normal_matvec", "normal_matvec_plain", "supported",
           "launches", "reset_launches"]

# Kernel launches since the last reset_launches(); a run reads it to show
# that its solver went through the kernel.
launches = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_X_DTYPE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
            torch.float16: torch.float32, torch.float64: torch.float64}
# Hopper: 227 KB of shared memory per CTA at most; the tile is sized so
# that two CTAs fit on one SM's 228 KB (less 1 KB reserved per CTA).
_SMEM_MAX = 232448
_SMEM_TWO_CTAS = (233472 - 2 * 1024) // 2
_MAX_TM = 32
# CTAs per SM the row splits aim at: enough to keep bytes in flight while
# the per-split partial-u scratch stays small against A.
_CTAS_PER_SM = 4

_SM_COUNT: Dict[int, int] = {}
_FN = None


def reset_launches() -> None:
    global launches
    launches = 0


def _tile_rows(n: int, a_dtype: torch.dtype) -> Optional[Tuple[int, int, int]]:
    """``(tm, tile_offset, smem_bytes)`` for blocks of width ``n``: the
    most rows (≤ 32) whose tile, with x and the partial u staged beside
    it, fits two CTAs per SM, else one row if that fits one CTA; ``None``
    when even one row does not fit (the caller takes the two-sweep
    path)."""
    acc = _X_DTYPE[a_dtype].itemsize
    item = a_dtype.itemsize

    def layout(tm):
        off = (2 * n * acc + tm * acc + 15) // 16 * 16
        return off, off + tm * n * item

    best = None
    for tm in range(1, _MAX_TM + 1):
        off, total = layout(tm)
        if total <= _SMEM_TWO_CTAS:
            best = (tm, off, total)
    if best is None:
        off, total = layout(1)
        if total <= _SMEM_MAX:
            best = (1, off, total)
    return best


def supported(a_dtype: torch.dtype, x_dtype: torch.dtype, n: int) -> bool:
    """Whether the normal product takes blocks of ``a_dtype`` and width
    ``n`` with vectors of ``x_dtype`` (see the module's dtype rules)."""
    return (a_dtype in _X_DTYPE and _X_DTYPE[a_dtype] == x_dtype
            and _tile_rows(int(n), a_dtype) is not None)


def _check(A: torch.Tensor, X: torch.Tensor) -> None:
    if A.ndim != 3 or X.ndim != 2:
        raise ValueError(f"normal_matvec needs A (nblk, m, n) and X (nblk, n); "
                         f"got {tuple(A.shape)} and {tuple(X.shape)}")
    if X.shape != (A.shape[0], A.shape[2]):
        raise ValueError(f"X shape {tuple(X.shape)} does not match A "
                         f"{tuple(A.shape)}: expected {(A.shape[0], A.shape[2])}")
    if _X_DTYPE.get(A.dtype) != X.dtype:
        raise ValueError(f"normal_matvec takes A float32/bfloat16/float16 "
                         f"with X float32, or float64 with float64; got "
                         f"A {A.dtype}, X {X.dtype}")
    if A.device != X.device:
        raise ValueError(f"A on {A.device} but X on {X.device}")


def normal_matvec_plain(A: torch.Tensor, X: torch.Tensor):
    """Plain PyTorch version: ``A`` widened to X's dtype, then
    ``q = A x`` and ``u = Aᵀ q`` (``q`` unrounded, as in the kernel)."""
    _check(A, X)
    Aw = A.to(X.dtype)
    q = torch.bmm(Aw, X.unsqueeze(-1))
    u = torch.bmm(Aw.transpose(1, 2), q)
    return u.squeeze(-1), q.squeeze(-1)


def _kernel_fn():
    global _FN
    if _FN is None:
        lib = _build.load("normal_matvec")
        fn = lib.normal_matvec_launch
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        lib.normal_matvec_error_string.argtypes = [ctypes.c_int]
        lib.normal_matvec_error_string.restype = ctypes.c_char_p
        _FN = (fn, lib.normal_matvec_error_string)
    return _FN


def normal_matvec(A: torch.Tensor, X: torch.Tensor):
    """``(u, q) = (AᵀA x, A x)`` per block, reading each block once.

    A CUDA tensor launches ``csrc/normal_matvec.cu`` on the current
    stream; a CPU tensor takes :func:`normal_matvec_plain`."""
    if A.device.type == "cpu" and X.device.type == "cpu":
        return normal_matvec_plain(A, X)
    _check(A, X)
    if A.device.type != "cuda":
        raise ValueError(f"normal_matvec runs on CUDA or CPU tensors, "
                         f"got {A.device}")
    if not (A.is_contiguous() and X.is_contiguous()):
        raise ValueError("normal_matvec needs contiguous A and X")
    nblk, m, n = A.shape
    plan = _tile_rows(n, A.dtype)
    if plan is None:
        raise ValueError(f"blocks of width n={n} at {A.dtype} do not fit "
                         "the kernel's shared memory; use the two-sweep "
                         "product (gate on supported())")
    tm, tile_offset, smem = plan
    U = torch.empty((nblk, n), dtype=X.dtype, device=A.device)
    Q = torch.empty((nblk, m), dtype=X.dtype, device=A.device)
    if U.numel() == 0 or Q.numel() == 0:
        return U.zero_(), Q.zero_()
    dev = A.device.index if A.device.index is not None \
        else torch.cuda.current_device()
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(dev) \
            .multi_processor_count
    ntiles = math.ceil(m / tm)
    splits = min(ntiles, max(1, math.ceil(_CTAS_PER_SM * _SM_COUNT[dev]
                                          / nblk)))
    per_split = math.ceil(ntiles / splits)
    splits = math.ceil(ntiles / per_split)
    scratch = torch.empty((splits, nblk, n), dtype=X.dtype, device=A.device)
    fn, errstr = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODES[A.dtype], A.data_ptr(), X.data_ptr(),
                 U.data_ptr(), Q.data_ptr(), scratch.data_ptr(), nblk, m, n,
                 tm, splits, per_split, tile_offset, smem, stream)
    if err != 0:
        raise RuntimeError(f"normal_matvec kernel launch failed: error {err} "
                           f"({errstr(err).decode()})")
    global launches
    launches += 1
    return U, Q
