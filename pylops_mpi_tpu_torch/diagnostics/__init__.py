"""Runtime observability: spans, metrics, stage budgets, the cost model,
in-loop telemetry and the fleet trace aggregator.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics``: :mod:`.trace`
(the span tracer), :mod:`.metrics` (the process-wide registry with its
periodic snapshot), :mod:`.profiler` (the stage-budget table, the
deadline runner and ``torch.profiler`` capture), :mod:`.costmodel` (per
operator costs, the card's peaks and the roofline), :mod:`.telemetry`
(per-iteration solver scalars written on the device) and
:mod:`.aggregate` (per-rank traces merged on one clock; the CLI is
``python -m pylops_mpi_tpu_torch.diagnostics``).
"""

from . import aggregate, costmodel, metrics, profiler, telemetry, trace
from .metrics import (metrics_mode, metrics_enabled, inc, set_gauge,
                      observe, timer, snapshot, clear_metrics,
                      write_snapshot, read_snapshot, hist_quantiles)
from .profiler import (STAGE_BUDGETS, stage_budget, DeadlineRunner,
                       StageRecord, profile_capture)
from .trace import (trace_mode, trace_enabled, span, op_span, event, counter,
                    get_events, clear_events, dump, span_tree)
from .aggregate import (load_events, merge_traces, aggregate_files,
                        critical_path)
from .costmodel import (OpCost, estimate, register_cost, roofline,
                        summa_comm_volume, pencil_transpose_cost,
                        peak_flops, peak_hbm_gbps, peak_nvlink_gbps,
                        device_peaks)
from .telemetry import (telemetry_enabled, iteration, history,
                        clear_history, telemetry_signature)

# the JAX package's name for the fabric inside a host (ICI there, NVLink
# here)
peak_ici_gbps = peak_nvlink_gbps

__all__ = [
    "trace", "metrics", "profiler", "costmodel", "telemetry", "aggregate",
    "metrics_mode", "metrics_enabled", "inc", "set_gauge", "observe",
    "timer", "snapshot", "clear_metrics", "write_snapshot",
    "read_snapshot", "hist_quantiles",
    "trace_mode", "trace_enabled", "span", "op_span", "event", "counter",
    "get_events", "clear_events", "dump", "span_tree",
    "STAGE_BUDGETS", "stage_budget", "DeadlineRunner", "StageRecord",
    "profile_capture",
    "load_events", "merge_traces", "aggregate_files", "critical_path",
    "OpCost", "estimate", "register_cost", "roofline",
    "summa_comm_volume", "pencil_transpose_cost", "peak_flops",
    "peak_hbm_gbps", "peak_nvlink_gbps", "peak_ici_gbps", "device_peaks",
    "telemetry_enabled", "iteration", "history", "clear_history",
    "telemetry_signature",
]
