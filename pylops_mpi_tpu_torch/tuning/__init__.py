"""The plan cache and its keys.

PyTorch counterpart of ``pylops_mpi_tpu/tuning/cache.py`` and of the
key functions of ``tuning/plan.py``; the serving pool reads the banked
block widths to choose what to prewarm. The search, the plan seam
(``get_plan``) and the cost model are ROADMAP.md §A.7.
"""

from . import cache, plan
from .plan import cached_batch_widths, plan_key, shape_bucket

__all__ = ["cache", "plan", "cached_batch_widths", "plan_key",
           "shape_bucket"]
