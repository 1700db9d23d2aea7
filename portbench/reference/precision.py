"""The precisions the reference runs in: its own (f64), the one the
configurations state (f32, TF32 off), and the control's one step below
(TF32: the operands of every product rounded to a 10-bit mantissa, the
sums kept in f32, as the card's TF32 tensor cores compute)."""

from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f64", "f32", "tf32")


def dtype(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    return torch.float64 if precision == "f64" else torch.float32


def operand(t: torch.Tensor, precision: str) -> torch.Tensor:
    """``t`` as an operand of a product at ``precision``."""
    t = t.to(dtype(precision))
    if precision != "tf32":
        return t
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def no_tf32():
    """A context in which cuBLAS and cuDNN keep full f32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
