"""Environment configuration.

PyTorch counterpart of ``pylops_mpi_tpu/utils/deps.py``, holding only
the knobs this port reads, under the prefix ``PYLOPS_MPI_TPU_TORCH_``.

:func:`apply_environment` pins true-f32 products: PyTorch may run f32
matrix products and convolutions in TF32 (about three decimal digits)
when ``allow_tf32`` is set, which would break numeric parity with the
JAX package, whose import pins ``jax_default_matmul_precision=highest``.
Narrow storage stays available explicitly through ``compute_dtype``.
"""

from __future__ import annotations

import torch

__all__ = ["KNOBS", "apply_environment"]

# (name, values, default, consumer module, one-line purpose)
KNOBS = [
    ("PYLOPS_MPI_TPU_TORCH_PRECISION", "f32|bf16|c64", "f32",
     "ops/_precision.py",
     "storage-precision policy for operators built with "
     "compute_dtype=None"),
]


def apply_environment() -> None:
    """Pin full-f32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
