"""Multi-dimensional convolution (MDC).

PyTorch counterpart of ``pylops_mpi_tpu/ops/mdc.py:58-133`` (the
reference's ``pylops_mpi/waveeqprocessing/MDC.py:12-180``): the lazy
chain ``F1ᴴ · I1ᴴ · Fredholm1 · I · F``. ``F``/``F1`` are real FFTs along
time of the model and data (``ops/local.FFT``, cuFFT on the card),
``I``/``I1`` keep the first ``nfmax`` frequencies (``ops/local.Identity``)
and :class:`~.fredholm.MPIFredholm1` is the frequency-batched complex
product. The kernel is prescaled by ``dr·dt·√nt`` (ref ``MDC.py:37-43``).

Only the JAX package's ``engine="complex"`` chain is ported; its
``"planar"`` engine (real plane pairs for TPUs with no complex support)
raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from ..linearoperator import MPILinearOperator, aslinearoperator
from ..parallel.mesh import DeviceLike, require_world_of_one, resolve_device
from .fredholm import MPIFredholm1
from .local import FFT as _LocalFFT, Identity as _LocalIdentity

__all__ = ["MPIMDC"]


def MPIMDC(G, nt: int, nv: int, nfreq: Optional[int] = None, dt: float = 1.0,
           dr: float = 1.0, twosided: bool = True, saveGt: bool = True,
           conj: bool = False, prescaled: bool = False, compute_dtype=None,
           engine: Optional[str] = None,
           device: DeviceLike = None) -> MPILinearOperator:
    """MDC operator (ref ``MDC.py:82-180``). ``G`` is the frequency-domain
    kernel ``(nfmax, ns, nr)``, a tensor (kept on its device unless
    ``device`` is given) or a numpy array (placed on ``device``, default
    ``"cuda"``). The model is ``(nt, nr, nv)`` and the data
    ``(nt, ns, nv)``, both real, time first. ``compute_dtype`` narrows
    the stored kernel (``MPIFredholm1(compute_dtype=...)``); with
    ``saveGt`` the operator keeps ``Gᴴ`` beside ``G``, twice the
    kernel's memory. ``engine``: ``"complex"`` or ``None`` (the same)."""
    require_world_of_one("MPIMDC", "A.3")
    if engine is None:
        engine = "complex"
    if engine == "planar":
        raise NotImplementedError(
            "MPIMDC(engine='planar') is not ported; use engine='complex'")
    if engine != "complex":
        raise ValueError(f"engine must be 'complex', 'planar' or None, "
                         f"got {engine!r}")
    if isinstance(G, torch.Tensor):
        if device is not None:
            G = G.to(resolve_device(device))
    else:
        G = torch.tensor(np.asarray(G)).to(resolve_device(device))
    if twosided and nt % 2 == 0:
        raise ValueError("nt must be odd number")
    dtype = G.dtype
    rdtype = dtype.to_real() if dtype.is_complex else dtype
    nfmax, ns, nr = G.shape
    nfft = int(np.ceil((nt + 1) / 2))
    nfmax_req = nfmax if nfreq is None else nfreq
    if nfmax_req > nfft:
        nfmax_req = nfft
        logging.warning("nfmax set equal to ceil[(nt+1)/2]=%d" % nfft)
    if nfmax_req != nfmax:
        G = G[:nfmax_req]
        nfmax = nfmax_req

    scale = 1.0 if prescaled else dr * dt * np.sqrt(nt)
    Frop = MPIFredholm1(G * scale, nv, saveGt=saveGt, dtype=dtype,
                        compute_dtype=compute_dtype)
    if conj:
        Frop = Frop.conj()
    Fop = aslinearoperator(_LocalFFT((nt, nr, nv), axis=0, real=True,
                                     ifftshift_before=twosided,
                                     dtype=rdtype))
    F1op = aslinearoperator(_LocalFFT((nt, ns, nv), axis=0, real=True,
                                      ifftshift_before=False, dtype=rdtype))
    Iop = aslinearoperator(_LocalIdentity(nfmax * nr * nv, nfft * nr * nv,
                                          dtype=dtype))
    I1op = aslinearoperator(_LocalIdentity(nfmax * ns * nv, nfft * ns * nv,
                                           dtype=dtype))
    MDCop = F1op.H * I1op.H * Frop * Iop * Fop
    # the chain's dtype promotes to complex; model and data are real
    MDCop.dtype = rdtype
    return MDCop
