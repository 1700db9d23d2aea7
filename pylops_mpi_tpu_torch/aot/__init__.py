"""Signatures for a future bank of captured programs.

PyTorch counterpart of the signature half of ``pylops_mpi_tpu/aot``.
The bank itself, captured CUDA graphs keyed by these signatures, is
ROADMAP.md §A.7; until it exists :func:`aot_enabled` is false and the
serving pool's prewarm never skips a bucket.
"""

from .signature import compile_signature, op_signature

__all__ = ["aot_enabled", "compile_signature", "op_signature"]


def aot_enabled() -> bool:
    """Whether a bank of captured programs serves prewarm: never yet."""
    return False
