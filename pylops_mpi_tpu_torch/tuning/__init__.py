"""Autotuning: measured plan selection for the operators.

PyTorch counterpart of ``pylops_mpi_tpu/tuning``:

- :mod:`.space`: the declared plan spaces and their cost-model seeds;
- :mod:`.search`: budget-bounded measurement of the top candidates;
- :mod:`.cache`: the plan-cache file (``PYLOPS_MPI_TPU_TORCH_TUNE_CACHE``);
- :mod:`.plan`: :func:`get_plan`, the seam the operator constructors
  consult under ``PYLOPS_MPI_TPU_TORCH_TUNE=on|auto`` (default ``off``:
  nothing changes; explicit keyword arguments always win).

``python -m pylops_mpi_tpu_torch.tuning`` sweeps the operator families
and banks a plan cache.
"""

from . import cache
from .plan import (Plan, applied_provenance, cached_batch_widths,
                   chunk_hint, get_plan, plan_key, record_chunk_plan,
                   reset_applied, shape_bucket, tune_enabled, tune_mode)
from .search import measure_candidates
from .space import (Axis, TuningSpace, candidates, default_params, rank,
                    register_space, space_for)

__all__ = ["Plan", "get_plan", "tune_mode", "tune_enabled", "plan_key",
           "shape_bucket", "chunk_hint", "record_chunk_plan",
           "applied_provenance", "reset_applied", "cached_batch_widths",
           "Axis", "TuningSpace", "space_for", "register_space",
           "candidates", "rank", "default_params", "measure_candidates",
           "cache"]
