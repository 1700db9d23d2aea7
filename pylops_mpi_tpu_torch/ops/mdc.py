"""Multi-dimensional convolution (MDC).

PyTorch counterpart of ``pylops_mpi_tpu/ops/mdc.py:58-133`` (the
reference's ``pylops_mpi/waveeqprocessing/MDC.py:12-180``): the lazy
chain ``F1ᴴ · I1ᴴ · Fredholm1 · I · F``. ``F``/``F1`` are real FFTs along
time of the model and data (``ops/local.FFT``, cuFFT on the card),
``I``/``I1`` keep the first ``nfmax`` frequencies (``ops/local.Identity``)
and :class:`~.fredholm.MPIFredholm1` is the frequency-batched complex
product. The kernel is prescaled by ``dr·dt·√nt`` (ref ``MDC.py:37-43``).

Every rank applies the FFTs to the whole BROADCAST model and data, which
repeats that work on each rank, as the JAX package and the reference
do; only the Fredholm core is split over the ranks (each its chunk of
the frequencies) and communicates.

Only the JAX package's ``engine="complex"`` chain is ported; its
``"planar"`` engine (real plane pairs for TPUs with no complex support)
raises.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from ..linearoperator import MPILinearOperator, aslinearoperator
from ..parallel.mesh import DeviceLike
from ._precision import as_torch_dtype
from .fredholm import MPIFredholm1
from .local import FFT as _LocalFFT, Identity as _LocalIdentity

__all__ = ["MPIMDC"]


def MPIMDC(G, nt: int, nv: int, nfreq: Optional[int] = None, dt: float = 1.0,
           dr: float = 1.0, twosided: bool = True, saveGt: bool = True,
           conj: bool = False, prescaled: bool = False, mesh=None,
           compute_dtype=None, engine: Optional[str] = None, *,
           device: DeviceLike = None) -> MPILinearOperator:
    """MDC operator (ref ``MDC.py:82-180``). ``G`` is the whole
    frequency-domain kernel ``(nfmax, ns, nr)`` on every rank, a tensor
    or a numpy array: the rank keeps its chunk of the frequencies
    (:class:`~.fredholm.MPIFredholm1`), which stays on a tensor's device
    unless ``device`` is given, and goes to ``device`` (default
    ``"cuda"``) from an array. The model is ``(nt, nr, nv)`` and the data
    ``(nt, ns, nv)``, both real, time first. ``compute_dtype`` narrows
    the stored kernel (``MPIFredholm1(compute_dtype=...)``); with
    ``saveGt`` the operator keeps ``Gᴴ`` beside ``G``, twice the
    kernel's memory. ``mesh`` keeps the JAX package's argument order and
    must describe the process group. ``engine``: ``"complex"`` or
    ``None`` (the same)."""
    if engine is None:
        engine = "complex"
    if engine == "planar":
        raise NotImplementedError(
            "MPIMDC(engine='planar') is not ported; use engine='complex'")
    if engine != "complex":
        raise ValueError(f"engine must be 'complex', 'planar' or None, "
                         f"got {engine!r}")
    if twosided and nt % 2 == 0:
        raise ValueError("nt must be odd number")
    dtype = as_torch_dtype(G.dtype)
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
    Frop = MPIFredholm1(G, nv, saveGt, True, mesh, dtype, compute_dtype,
                        scale=scale, device=device)
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
