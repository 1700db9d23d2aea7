"""Namespace parity with ``pylops_mpi.waveeqprocessing`` (JAX
``pylops_mpi_tpu/waveeqprocessing``)."""
from ..ops.mdc import MPIMDC
