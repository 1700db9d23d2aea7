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

The kernel is persistent: :func:`plan` splits the ``nblk·m`` rows of the
whole stack evenly over one or two CTAs per SM, each CTA streaming its
contiguous row range (which may cross block boundaries) through a ring
of shared-memory stages. A CTA keeps one partial u per block segment it
touches; a second, small kernel sums each block's segments in a fixed
order, so the result is bitwise the same from call to call.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["normal_matvec", "normal_matvec_plain", "supported", "plan",
           "NormalPlan", "device_plan", "kernel_info", "launches",
           "launches_by_dtype", "reset_launches"]

# Kernel launches since the last reset_launches(); a run reads it to show
# that its solver went through the kernel. ``launches_by_dtype`` splits
# them by the dtype of A: bf16/f16 are the JAX package's
# ``_normal_kernel_stream``, f32/f64 its ``_normal_kernel``.
launches = 0
launches_by_dtype: Counter = Counter()

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
                torch.float64: 3}
_X_DTYPE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
            torch.float16: torch.float32, torch.float64: torch.float64}

# Hopper: 228 KB of shared memory per SM, 227 KB of it to one CTA at
# most, 1 KB of each CTA's reserved by the system.
_SMEM_SM = 233472
_SMEM_CTA_MAX = 232448
_SMEM_RESERVED = 1024
# Must match csrc/normal_matvec.cu: the consumer threads, the bytes
# before the ring (barriers, row-dot slots), the stage cap, and the
# register buckets of 16-byte column chunks per consumer thread.
_CONSUMERS = 256
_HEADER = 2304
_MAX_STAGES = 16
_KC_BUCKETS = (1, 2, 4, 8, 24)
# Bytes of A one stage carries: with the ring's other stages in flight,
# an SM keeps well over the ~32 KB that Little's law asks for at
# 3.35 TB/s over 132 SMs.
_STAGE_BYTES = 32 * 1024
_MAX_ROWS_PER_STAGE = 64

_DEVICE_PLANS: Dict[tuple, Optional["NormalPlan"]] = {}
_FN = None


def reset_launches() -> None:
    global launches
    launches = 0
    launches_by_dtype.clear()


@dataclass(frozen=True)
class NormalPlan:
    """How the kernel runs one ``(nblk, m, n)`` stack.

    ``kc``: 16-byte column chunks a consumer thread holds in registers;
    ``rows_per_stage`` rows of A per ring stage (fewer where a block
    segment ends), ``stages`` ring stages of ``stage_bytes`` each,
    ``smem_bytes`` of dynamic shared memory per CTA, ``ctas`` CTAs
    (``ctas_per_sm`` on each of ``sm_count`` SMs at most).
    ``cta_rows[i]`` is CTA i's half-open range of flattened rows;
    ``segments[b]`` lists block b's segments in order as
    ``(slot, cta, row_start, row_end)``, where ``slot = cta + b`` keys
    the segment's partial u in the scratch of ``scratch_slots`` rows."""
    nblk: int
    m: int
    n: int
    kc: int
    rows_per_stage: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    ctas: int
    ctas_per_sm: int
    sm_count: int
    cta_rows: Tuple[Tuple[int, int], ...]
    segments: Tuple[Tuple[Tuple[int, int, int, int], ...], ...]

    @property
    def scratch_slots(self) -> int:
        return self.ctas + self.nblk - 1


def _round_up(v: int, k: int) -> int:
    return (v + k - 1) // k * k


def _stage_config(n: int, a_dtype: torch.dtype, ctas_per_sm: int):
    """``(kc, rows_per_stage, stages, stage_bytes, smem_bytes)`` for
    blocks of width ``n``, or ``None`` when the kernel cannot take it
    (a consumer thread would need more than 24 chunks, or one row does
    not fit the shared memory of one CTA)."""
    item = a_dtype.itemsize
    per_chunk = 16 // item
    kc = next((k for k in _KC_BUCKETS if k * _CONSUMERS * per_chunk >= n),
              None)
    if kc is None:
        return None
    row_bytes = n * item
    budget = min(_SMEM_CTA_MAX,
                 _SMEM_SM // ctas_per_sm - _SMEM_RESERVED) - _HEADER

    def stage_bytes(rows):
        # + 16: a stage's first byte sits at its address modulo 16
        return _round_up(rows * row_bytes + 16, 128)

    rows = max(1, min(_MAX_ROWS_PER_STAGE, _STAGE_BYTES // row_bytes))
    while rows > 1 and budget // stage_bytes(rows) < 2:
        rows -= 1
    stages = min(_MAX_STAGES, budget // stage_bytes(rows))
    if stages < 1:
        return None
    sb = stage_bytes(rows)
    return kc, rows, stages, sb, _HEADER + stages * sb


def _owner(r: int, rows: int, ctas: int) -> int:
    """The CTA whose range holds flattened row ``r`` (the kernel's
    formula)."""
    return ((r + 1) * ctas - 1) // rows


@functools.lru_cache(maxsize=64)
def plan(nblk: int, m: int, n: int, a_dtype: torch.dtype, sm_count: int,
         ctas_per_sm: int = 2) -> Optional[NormalPlan]:
    """The kernel's plan for A ``(nblk, m, n)`` of ``a_dtype`` on a card
    with ``sm_count`` SMs running ``ctas_per_sm`` CTAs each; ``None``
    when the kernel cannot take blocks of width ``n``. Pure: no device
    is touched."""
    cfg = _stage_config(n, a_dtype, ctas_per_sm)
    if cfg is None or nblk < 1 or m < 1:
        return None
    kc, rows, stages, sb, smem = cfg
    total = nblk * m
    ctas = min(sm_count * ctas_per_sm, total)
    starts = [i * total // ctas for i in range(ctas + 1)]
    cta_rows = tuple(zip(starts[:-1], starts[1:]))
    segments = []
    for b in range(nblk):
        lo, hi = b * m, (b + 1) * m
        segments.append(tuple(
            (i + b, i, max(starts[i], lo), min(starts[i + 1], hi))
            for i in range(_owner(lo, total, ctas),
                           _owner(hi - 1, total, ctas) + 1)))
    return NormalPlan(nblk, m, n, kc, rows, stages, sb, smem, ctas,
                      ctas_per_sm, sm_count, cta_rows, tuple(segments))


def supported(a_dtype: torch.dtype, x_dtype: torch.dtype, n: int) -> bool:
    """Whether the normal product takes blocks of ``a_dtype`` and width
    ``n`` with vectors of ``x_dtype`` (see the module's dtype rules)."""
    return (a_dtype in _X_DTYPE and _X_DTYPE[a_dtype] == x_dtype
            and _stage_config(int(n), a_dtype, 1) is not None)


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
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        info = lib.normal_matvec_kernel_info
        info.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
        info.restype = ctypes.c_int
        lib.normal_matvec_error_string.argtypes = [ctypes.c_int]
        lib.normal_matvec_error_string.restype = ctypes.c_char_p
        _FN = (fn, info, lib.normal_matvec_error_string)
    return _FN


def kernel_info(a_dtype: torch.dtype, kc: int, smem_bytes: int) -> dict:
    """The compiled instantiation's registers per thread, local (spill)
    bytes per thread and resident CTAs per SM at ``smem_bytes`` of
    dynamic shared memory, as the CUDA runtime reports them."""
    _, info, errstr = _kernel_fn()
    out = [ctypes.c_int(0) for _ in range(3)]
    err = info(_DTYPE_CODES[a_dtype], kc, smem_bytes,
               *(ctypes.addressof(o) for o in out))
    if err != 0:
        raise RuntimeError(f"normal_matvec kernel query failed: error {err} "
                           f"({errstr(err).decode()})")
    return dict(registers=out[0].value, local_bytes=out[1].value,
                ctas_per_sm=out[2].value)


def device_plan(nblk: int, m: int, n: int, a_dtype: torch.dtype,
                dev: int) -> Optional[NormalPlan]:
    """:func:`plan` for CUDA device ``dev``: two CTAs per SM where the
    runtime says two of the chosen instantiation fit, else one."""
    key = (dev, nblk, m, n, a_dtype)
    if key in _DEVICE_PLANS:
        return _DEVICE_PLANS[key]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    two = _stage_config(n, a_dtype, 2)
    cps = 1
    if two is not None and two[2] >= 2:
        with torch.cuda.device(dev):
            if kernel_info(a_dtype, two[0], two[4])["ctas_per_sm"] >= 2:
                cps = 2
    _DEVICE_PLANS[key] = p = plan(nblk, m, n, a_dtype, sms, cps)
    return p


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
    U = torch.empty((nblk, n), dtype=X.dtype, device=A.device)
    Q = torch.empty((nblk, m), dtype=X.dtype, device=A.device)
    if U.numel() == 0 or Q.numel() == 0:
        return U.zero_(), Q.zero_()
    dev = A.device.index if A.device.index is not None \
        else torch.cuda.current_device()
    p = device_plan(nblk, m, n, A.dtype, dev)
    if p is None:
        raise ValueError(f"blocks of width n={n} at {A.dtype} are beyond "
                         "the kernel's registers or shared memory; use the "
                         "two-sweep product (gate on supported())")
    scratch = torch.empty((p.scratch_slots, n), dtype=X.dtype,
                          device=A.device)
    fn, _, errstr = _kernel_fn()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPE_CODES[A.dtype], p.kc, A.data_ptr(), X.data_ptr(),
                 U.data_ptr(), Q.data_ptr(), scratch.data_ptr(), nblk, m, n,
                 p.ctas, p.rows_per_stage,
                 p.stages, p.stage_bytes, p.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"normal_matvec kernel launch failed: error {err} "
                           f"({errstr(err).decode()})")
    global launches
    launches += 1
    launches_by_dtype[str(A.dtype).rsplit(".", 1)[-1]] += 1
    return U, Q
