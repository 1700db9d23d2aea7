"""Shard-layout plots (JAX ``pylops_mpi_tpu/plotting``)."""
from .plotting import plot_distributed_array, plot_local_arrays
