"""Mixed-precision policy: storage vs compute vs reduction dtypes.

PyTorch counterpart of ``pylops_mpi_tpu/ops/_precision.py``:

- **storage dtype** — what an operator's matrix blocks live at in
  device memory. Narrow storage (bf16 for f32 operators, c64 for c128)
  halves the bytes every apply reads.
- **compute dtype** — what the contraction's *matrix* operand enters at.
  The **vector operand is never narrowed**: rounding the solver's
  vectors to bf16 each iteration caps the attainable accuracy at ~1e-3.
- **reduction dtype** — what dot products, norms and recurrence scalars
  accumulate at: never below float32.

The policy is resolved once from ``PYLOPS_MPI_TPU_TORCH_PRECISION``
(``f32``/unset → no narrowing, ``bf16`` → bf16 storage for f32
operators, ``c64`` → complex64 storage for complex128 operators);
:func:`set_precision` overrides it. An explicit ``compute_dtype``
always wins.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = ["PrecisionPolicy", "get_policy", "set_precision",
           "as_torch_dtype", "result_dtype", "default_compute_dtype",
           "reduction_dtype", "accum_dtype", "check_compute_dtype",
           "matmul_narrow", "escalate_dtype", "effective_compute_dtype",
           "dtype_name"]


class PrecisionPolicy(NamedTuple):
    name: str
    storage_real: Optional[torch.dtype]
    storage_complex: Optional[torch.dtype]
    reduction_min: torch.dtype


_POLICIES = {
    "f32": PrecisionPolicy("f32", None, None, torch.float32),
    "bf16": PrecisionPolicy("bf16", torch.bfloat16, None, torch.float32),
    "c64": PrecisionPolicy("c64", None, torch.complex64, torch.float32),
}

_policy_cache: Optional[PrecisionPolicy] = None


def get_policy() -> PrecisionPolicy:
    """The active policy: the cached first resolution of
    ``PYLOPS_MPI_TPU_TORCH_PRECISION`` (unknown values fall back to
    ``f32`` with a warning)."""
    global _policy_cache
    if _policy_cache is None:
        name = os.environ.get("PYLOPS_MPI_TPU_TORCH_PRECISION", "f32").lower()
        if name in ("", "none", "default"):
            name = "f32"
        if name not in _POLICIES:
            warnings.warn(
                f"PYLOPS_MPI_TPU_TORCH_PRECISION={name!r} is not one of "
                f"{sorted(_POLICIES)}; using 'f32' (no narrowing)",
                stacklevel=2)
            name = "f32"
        _policy_cache = _POLICIES[name]
    return _policy_cache


def set_precision(name: Optional[str]) -> PrecisionPolicy:
    """Programmatic override (``None`` re-reads the environment).
    Operators resolve their storage dtype at construction."""
    global _policy_cache
    if name is None:
        _policy_cache = None
        return get_policy()
    if name not in _POLICIES:
        raise ValueError(f"unknown precision policy {name!r}; "
                         f"expected one of {sorted(_POLICIES)}")
    _policy_cache = _POLICIES[name]
    return _policy_cache


def as_torch_dtype(dtype) -> Optional[torch.dtype]:
    """A torch dtype from a torch dtype, numpy dtype or dtype name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and hasattr(torch, dtype):
        return getattr(torch, dtype)
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def result_dtype(*dtypes) -> Optional[torch.dtype]:
    """Promotion of the operands' dtypes (``None`` entries skipped)."""
    out = None
    for dt in dtypes:
        if dt is not None:
            dt = as_torch_dtype(dt)
            out = dt if out is None else torch.promote_types(out, dt)
    return out


def default_compute_dtype(op_dtype) -> Optional[torch.dtype]:
    """Storage dtype an operator of ``op_dtype`` uses when built with
    ``compute_dtype=None``: only f32 under the bf16 policy and c128
    under the c64 policy narrow."""
    pol = get_policy()
    dt = as_torch_dtype(op_dtype)
    if pol.storage_real is not None and dt == torch.float32:
        return pol.storage_real
    if pol.storage_complex is not None and dt == torch.complex128:
        return pol.storage_complex
    return None


def reduction_dtype(carry_dtype) -> torch.dtype:
    """Accumulation dtype of recurrence scalars over vectors of
    ``carry_dtype``: the carry's real counterpart, floored at f32."""
    dt = as_torch_dtype(carry_dtype)
    floor = get_policy().reduction_min
    if dt.is_complex:
        real = dt.to_real()
        return real if real.itemsize >= floor.itemsize else floor
    if dt.is_floating_point and dt.itemsize >= floor.itemsize:
        return dt
    return floor


def accum_dtype(dtype) -> torch.dtype:
    """Accumulation dtype for elementwise-product and abs reductions:
    sub-f32 floats accumulate at f32, everything else is unchanged."""
    dt = as_torch_dtype(dtype)
    if dt.is_floating_point and dt.itemsize < 4:
        return torch.float32
    return dt


# The one-rung escalation ladder of the resilience tier (JAX
# ``_precision.py:159-184``): a solve that breaks down under narrow
# storage restarts one rung wider, bf16/f16 → f32 → f64 and c64 → c128.
# Torch always has the f64 rung (the JAX package needs x64 for it).
_ESCALATION = {torch.bfloat16: torch.float32, torch.float16: torch.float32,
               torch.float32: torch.float64,
               torch.complex64: torch.complex128}


def escalate_dtype(dtype) -> Optional[torch.dtype]:
    """The next-wider storage dtype, or ``None`` at the top."""
    return _ESCALATION.get(as_torch_dtype(dtype))


def effective_compute_dtype(Op) -> torch.dtype:
    """The dtype an operator's matrices live at: its resolved
    ``compute_dtype`` where it has one, else its dtype."""
    cdt = getattr(Op, "compute_dtype", None)
    return as_torch_dtype(cdt if cdt is not None else Op.dtype)


def dtype_name(dtype) -> str:
    """numpy's name of a dtype (``"bfloat16"``, ``"float32"``), the one
    the JAX package's attempt records carry."""
    return str(as_torch_dtype(dtype)).rsplit(".", 1)[-1]


def check_compute_dtype(compute_dtype, op_dtype, where: str) -> None:
    """Reject real narrow storage of complex operators, which would
    discard the imaginary parts."""
    if compute_dtype is None:
        return
    cdt, odt = as_torch_dtype(compute_dtype), as_torch_dtype(op_dtype)
    if odt.is_complex and not cdt.is_complex:
        raise ValueError(
            f"{where}: compute_dtype={cdt} would discard the imaginary "
            f"part of a {odt} operator; use a complex compute_dtype "
            "(e.g. torch.complex64) or drop it")


def matmul_narrow(A: torch.Tensor, X: torch.Tensor, compute_dtype,
                  out_dtype) -> torch.Tensor:
    """Batched ``A @ X`` under the narrow-storage rule. ``A`` is stored
    at ``compute_dtype`` (or the operator dtype); it is widened to the
    product's dtype for the contraction, and ``X`` keeps its own dtype
    (never narrowed). With a ``compute_dtype`` the result is at least
    ``out_dtype`` (the operator dtype), as ``preferred_element_type``
    makes it in the JAX package.

    The widening is a copy of ``A`` per call on the classic (two-sweep)
    path; the normal-product kernel widens inside the kernel instead."""
    acc = torch.promote_types(A.dtype, X.dtype)
    if compute_dtype is not None:
        acc = torch.promote_types(acc, as_torch_dtype(out_dtype))
    return torch.matmul(A.to(acc), X.to(acc))
