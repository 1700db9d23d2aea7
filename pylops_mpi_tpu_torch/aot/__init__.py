"""The bank of captured solver loops (``PYLOPS_MPI_TPU_TORCH_AOT``).

PyTorch counterpart of ``pylops_mpi_tpu/aot``'s in-process half: the
structural signatures (:mod:`.signature`), the knob and the memory bank
(:mod:`.store`) and the capture-and-replay seam (:mod:`.graphs`). With
the knob ``on`` the fused loops of ``cg``/``cgls`` (both schedules,
``M=`` and ``guards=``), ``block_cg``/``block_cgls``, ``ista``/``fista``,
the pipelined and s-step engines and ``power_iteration`` run each
segment between two host checks as a CUDA graph, captured once per key
and replayed; the serving pool's prewarm captures each (family, bucket)
and skips a banked one. A graph lives in its process and holds the
operator's device addresses: there is no disk bank (:mod:`.store`).
"""

from .graphs import capture_count, reset_capture_count
from .signature import compile_signature, op_signature, storage_signature
from .store import aot_enabled, aot_mode, clear_memory

__all__ = ["aot_enabled", "aot_mode", "clear_memory", "capture_count",
           "reset_capture_count", "compile_signature", "op_signature",
           "storage_signature"]
