"""Device and world resolution.

PyTorch counterpart of ``pylops_mpi_tpu/parallel/mesh.py``, reduced to
what a one-process, one-device port needs: which device an entry point
runs on, and how many workers share a ``SCATTER`` split. There is no
process group yet; multi-GPU sharding over ``torch.distributed`` (NCCL)
is a later step, and until then the world is one worker and every
array is global on its device.

Entry points run on the card unless the caller asks for the CPU: the
default device is ``"cuda"``, and asking for it on a machine without a
GPU raises instead of quietly running on the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["default_device", "set_default_device", "resolve_device",
           "world_size"]

DeviceLike = Union[str, torch.device, None]

_DEFAULT_DEVICE = torch.device("cuda")


def default_device() -> torch.device:
    """The device entry points use when called without ``device=``."""
    return _DEFAULT_DEVICE


def set_default_device(device: DeviceLike) -> None:
    """Change the process-wide default device (``None`` restores
    ``"cuda"``)."""
    global _DEFAULT_DEVICE
    _DEFAULT_DEVICE = torch.device("cuda" if device is None else device)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a :class:`torch.device`, defaulting to
    :func:`default_device`. A CUDA device on a machine without one
    raises: the port never falls back to the CPU on its own."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pylops_mpi_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    return dev


def world_size() -> int:
    """Number of workers sharing a SCATTER split: one process, one
    device in this port."""
    return 1
