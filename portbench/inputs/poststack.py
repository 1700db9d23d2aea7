"""Inputs of the post-stack deployment, made on the device from the seed.

Each right-hand side ``j`` is a layered impedance model (PyLops-MPI's
``tutorials/poststack.py``: a random walk along time about 2.0, one per
trace) drawn in f64 from its own generator, and its data ``0.5·W·D m``
computed by the plain reference's forward operator in f64 and stored in f32.
Plain PyTorch: the program under test is not imported.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.harness.seeding import generator

_M = 3


def wavelet(cfg: dict) -> np.ndarray:
    """The Ricker wavelet of the configuration, on its symmetric time
    axis: ``ricker(arange(0, wav_t_max, wav_dt), f0)``."""
    t = np.arange(0.0, float(cfg["wav_t_max"]), float(cfg["wav_dt"]))
    t = np.concatenate([-t[:0:-1], t])
    f0 = float(cfg["wav_f0"])
    return (1 - 2 * (np.pi * f0 * t) ** 2) * np.exp(-(np.pi * f0 * t) ** 2)


def model(cfg: dict, seed: int, j: int, device) -> torch.Tensor:
    """The ``j``-th layered model ``(nx, nt0)``, f64."""
    nx, nt0 = int(cfg["nx"]), int(cfg["nt0"])
    steps = torch.randn((nx, nt0), generator=generator(seed, _M, j, device),
                        device=device, dtype=torch.float64)
    steps.mul_(0.03)
    return torch.cumsum(steps, dim=1).add_(2.0)
