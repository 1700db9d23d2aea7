"""Namespace parity with ``pylops_mpi.signalprocessing`` (JAX
``pylops_mpi_tpu/signalprocessing``)."""
from ..ops.fft import MPIFFTND, MPIFFT2D
from ..ops.fredholm import MPIFredholm1
from ..ops.nonstatconv import MPINonStationaryConvolve1D
