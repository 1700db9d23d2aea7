"""Per-operator cost models and roofline placement.

PyTorch counterpart of ``pylops_mpi_tpu/diagnostics/costmodel.py``:

- :class:`OpCost`: floating-point operations, device-memory bytes and
  bytes received from other devices for ONE apply of an operator, per
  rank (the JAX field names: ``hbm_bytes``, ``ici_bytes``,
  ``dcn_bytes``; on the card ``ici`` stands for NVLink);
- a registry (:func:`register_cost` / :func:`estimate`) with the JAX
  package's models of the operator families, resolved by the port's
  classes, recursing through the composition wrappers;
- :func:`summa_comm_volume` / :func:`summa_comm_volume_split`, the SUMMA
  volume model ``ops/matrixmult.py``'s ``schedule="auto"`` reads, and
  :func:`pencil_transpose_cost`;
- the card's peak tables in place of the TPU tables, keyed by a
  substring of ``torch.cuda.get_device_name``, most specific first, and
  :func:`roofline`, which turns a cost and peaks into a predicted time
  and the bound that sets it.

Counting conventions are the JAX package's: a real GEMM ``(m, k) @ (k,
n)`` is ``2·m·k·n`` operations, a complex one four times that; an FFT
``5·n·log2(n)``; device-memory bytes assume each operand and result
streams once per apply (matrices at their storage dtype); received
bytes follow the collective (an all-gather over ``P`` of ``B`` bytes
receives ``B·(P-1)/P``, an all-reduce ``2·B·(P-1)/P``).

Port extensions, beside the JAX families: ``estimate(op, "normal")``
for ``MPIBlockDiag``'s normal apply (one read of the block stack through
the normal kernel, two through the two-sweep path), and models for the
axis stencils of ``MPIGradient`` and for ``MPIGradient`` itself (the sum
of its axes), which the JAX registry leaves unknown.

**Peaks.** ``PEAK_TFLOPS``, ``PEAK_HBM_GBPS`` and ``PEAK_NVLINK_GBPS``
are NVIDIA's data-sheet figures for the H100 (dense tensor-core rates:
the sheet's sparsity figures halved); ``PEAK_DCN_GBPS`` is an assumed
InfiniBand NIC rate (JAX ``:99-236``). On a world spanning hosts with
several ranks a host (``parallel/topology.py``) the SUMMA and FFT models
charge their bytes to ``dcn_bytes`` as the JAX package charges a
topology-blind schedule (``:288-345``, ``:458-464``, ``:582-583``), and
``device_peaks`` gives the IB rate; on one host every model reads as
before. The port pins TF32 off
(``utils/deps.apply_environment``), so f32 products run at the FP32
rate outside the tensor cores: :func:`device_peaks` defaults to
``mode="f32"``. An unknown card gets ``None``, never a guess.

**The all-reduce latency** (the α term of ``CA=auto``): with no process
group no reduction is issued, so the card's latency is 0 (no entry);
under a gloo group it is ``host``'s 20 µs, the JAX figure for the CPU;
under NCCL it is the card's own α, measured once a process by
:func:`measure_allreduce_latency` (the slowest rank's, so every rank
makes the same choice), with ``ALLREDUCE_LATENCY_S["nccl"]`` the
placement figure where no measurement is taken.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ..parallel import topology as _topo

__all__ = ["OpCost", "estimate", "register_cost", "roofline",
           "summa_comm_volume", "summa_comm_volume_split",
           "pencil_transpose_cost", "peak_flops", "peak_hbm_gbps",
           "peak_nvlink_gbps", "peak_dcn_gbps", "allreduce_latency_s",
           "measure_allreduce_latency", "device_peaks", "L2_BYTES",
           "PEAK_TFLOPS", "PEAK_HBM_GBPS", "PEAK_NVLINK_GBPS",
           "PEAK_DCN_GBPS",
           "ALLREDUCE_LATENCY_S"]


# ------------------------------------------------------------- peak tables
# Dense peaks per card, TFLOP/s: (fp32 outside the tensor cores, tf32
# tensor cores, bf16 tensor cores), from NVIDIA's H100 data sheet (its
# tensor-core figures are with sparsity; these are half of them). Most
# specific key first; matched against the lower-cased device name.
PEAK_TFLOPS = [
    ("h100 nvl", (60.0, 417.5, 835.5)),
    ("h100 pcie", (51.0, 378.0, 756.5)),
    ("h100 80gb hbm3", (67.0, 494.5, 989.5)),
    ("h100 sxm", (67.0, 494.5, 989.5)),
]

# Device-memory bandwidth per card, GB/s (NVIDIA data sheet).
PEAK_HBM_GBPS = [
    ("h100 nvl", 3938.0),
    ("h100 pcie", 2000.0),
    ("h100 80gb hbm3", 3350.0),
    ("h100 sxm", 3350.0),
]

# NVLink bandwidth per card and direction, GB/s: half the data sheet's
# bidirectional total (SXM 900 GB/s over 18 links, NVL/PCIe bridges
# 600 GB/s). It takes the place of the TPU's ICI in the roofline.
PEAK_NVLINK_GBPS = [
    ("h100 nvl", 300.0),
    ("h100 pcie", 300.0),
    ("h100 80gb hbm3", 450.0),
    ("h100 sxm", 450.0),
]

# The second fabric between hosts, GB/s per card and direction (JAX
# ``PEAK_DCN_GBPS``, the TPU's DCN): an ASSUMED 400 Gb/s NDR InfiniBand
# NIC per card, 50 GB/s, the common H100 cluster build. Not measured: the
# port has run on one host only. It enters a roofline only through
# ``dcn_bytes``, which only a world spanning hosts produces.
PEAK_DCN_GBPS = [
    ("h100", 50.0),
]

# The card's L2 (H100 SXM and PCIe: 50 MB): an apply whose implied
# bandwidth exceeds the device memory's was served from it.
L2_BYTES = 50 * 1024 * 1024

# Small all-reduce latency by fabric, seconds (the α of the α–β model).
# ``ici``, ``dcn`` and ``host`` are the JAX package's placement figures
# (``host``: the CPU and gloo); ``nccl`` is the placement figure for a
# host-paced NCCL all_reduce on the card, about 380 µs for a group of
# one measured by chip_smoke.py phase 14 on an H100 80GB HBM3 at 700 W.
# Under an NCCL group :func:`device_peaks` measures the card's own.
ALLREDUCE_LATENCY_S = {
    "ici": 2e-6,
    "dcn": 50e-6,
    "host": 20e-6,
    "nccl": 380e-6,
}


def allreduce_latency_s(fabric: str) -> Optional[float]:
    """The table's latency for ``fabric``; ``None`` for an unknown
    name."""
    return ALLREDUCE_LATENCY_S.get((fabric or "").strip().lower())


def _lookup(table, device_kind: str):
    kind = (device_kind or "").lower()
    for key, val in table:
        if key in kind:
            return val
    return None


def peak_flops(device_kind: str, mode: str = "f32") -> Optional[float]:
    """The card's dense peak, FLOP/s: ``f32`` (outside the tensor
    cores, the port's products with TF32 off), ``tf32`` or ``bf16``
    (tensor cores). ``None`` for an unknown card."""
    row = _lookup(PEAK_TFLOPS, device_kind)
    if row is None:
        return None
    m = (mode or "").lower()
    tf = row[0] if m.startswith("f32") else (row[1] if m == "tf32"
                                               else row[2])
    return tf * 1e12


def peak_hbm_gbps(device_kind: str) -> Optional[float]:
    """The card's device-memory bandwidth, GB/s (``None``: unknown)."""
    return _lookup(PEAK_HBM_GBPS, device_kind)


def peak_dcn_gbps(device_kind: str) -> Optional[float]:
    """The assumed InfiniBand rate per card and direction, GB/s (see the
    table); ``None`` for an unknown card."""
    return _lookup(PEAK_DCN_GBPS, device_kind)


def peak_nvlink_gbps(device_kind: str) -> Optional[float]:
    """The card's NVLink bandwidth a direction, GB/s (``None``:
    unknown)."""
    return _lookup(PEAK_NVLINK_GBPS, device_kind)


_MEASURED: Dict[tuple, float] = {}


def measure_allreduce_latency(reps: int = 50, device=None,
                              refresh: bool = False) -> Optional[float]:
    """The seconds one host-paced all_reduce of a 1-element tensor takes
    under the current process group (``None`` without one): ``reps``
    calls timed between two synchronizations, then the slowest rank's
    figure (a ``max`` all_reduce), so every rank reads the same α. The
    result is cached per group size and backend; ``refresh`` measures
    again. Collective: every rank of the group must call it."""
    import torch
    from ..parallel import collectives
    from ..parallel.mesh import default_device, initialized, world_size
    if not initialized():
        return None
    import torch.distributed as dist
    backend = str(dist.get_backend())
    key = (world_size(), backend)
    if key in _MEASURED and not refresh:
        return _MEASURED[key]
    dev = torch.device(device) if device is not None else (
        default_device() if backend == "nccl" else torch.device("cpu"))
    t = torch.ones(1, dtype=torch.float32, device=dev)
    counts = (collectives.counts.copy(), collectives.received.copy())

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    collectives.all_reduce(t, "sum")  # the communicator's first use
    sync()
    t0 = time.perf_counter()
    for _ in range(max(1, int(reps))):
        collectives.all_reduce(t, "sum")
    sync()
    alpha = torch.tensor([(time.perf_counter() - t0) / max(1, int(reps))],
                         dtype=torch.float64, device=dev)
    collectives.all_reduce(alpha, "max")
    # the measurement is no part of any solve: leave the counts as found
    collectives.counts.clear()
    collectives.counts.update(counts[0])
    collectives.received.clear()
    collectives.received.update(counts[1])
    _MEASURED[key] = float(alpha)
    return _MEASURED[key]


def _latency_on_card() -> Optional[float]:
    """α for a solve on the card: none without a group, ``host`` under
    gloo, the measured NCCL figure under NCCL."""
    from ..parallel.mesh import initialized
    if not initialized():
        return None
    import torch.distributed as dist
    if str(dist.get_backend()) != "nccl":
        return allreduce_latency_s("host")
    return measure_allreduce_latency()


def device_peaks(device=None, mode: str = "f32") -> Dict:
    """Peak dict for :func:`roofline` from a ``torch.device`` (default:
    the port's default device). A CPU device gets what the JAX package
    returns off TPU (no peaks, the ``host`` latency); a card its table
    row, ``None`` entries for an unknown card."""
    import torch
    from ..parallel.mesh import default_device
    dev = default_device() if device is None else torch.device(device)
    if dev.type != "cuda":
        return {"flops": None, "hbm_gbps": None, "ici_gbps": None,
                "dcn_gbps": None,
                "allreduce_latency_s": allreduce_latency_s("host"),
                "device_kind": "cpu", "platform": "cpu"}
    kind = torch.cuda.get_device_name(dev)
    return {"flops": peak_flops(kind, mode),
            "hbm_gbps": peak_hbm_gbps(kind),
            "ici_gbps": peak_nvlink_gbps(kind),
            "dcn_gbps": (peak_dcn_gbps(kind)
                         if _topo.world_shape() is not None else None),
            "allreduce_latency_s": _latency_on_card(),
            "device_kind": kind, "platform": "cuda"}


# ----------------------------------------------------------------- OpCost
@dataclass
class OpCost:
    """Cost of ONE operator apply, per rank (JAX ``costmodel.py:191-238``):
    operations, device-memory bytes, bytes received over the card's
    links (``ici_bytes``) and over a slower second fabric
    (``dcn_bytes``), provenance ``notes``, and the latency-bound small
    all-reduces a unit of work issues (``reductions_per_iter``)."""

    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    notes: Tuple[str, ...] = field(default_factory=tuple)
    dcn_bytes: float = 0.0
    reductions_per_iter: float = 0.0

    def __add__(self, other: "OpCost") -> "OpCost":
        return OpCost(self.flops + other.flops,
                      self.hbm_bytes + other.hbm_bytes,
                      self.ici_bytes + other.ici_bytes,
                      self.notes + other.notes,
                      self.dcn_bytes + other.dcn_bytes,
                      self.reductions_per_iter
                      + other.reductions_per_iter)

    def scaled(self, k: float) -> "OpCost":
        return OpCost(self.flops * k, self.hbm_bytes * k,
                      self.ici_bytes * k, self.notes,
                      self.dcn_bytes * k, self.reductions_per_iter * k)

    def as_dict(self) -> Dict:
        return {"flops": self.flops, "hbm_bytes": self.hbm_bytes,
                "ici_bytes": self.ici_bytes,
                "dcn_bytes": self.dcn_bytes,
                "reductions_per_iter": self.reductions_per_iter,
                "notes": list(self.notes)}


def _itemsize(dt) -> int:
    if dt is None:
        return 4
    from ..ops._precision import as_torch_dtype
    return as_torch_dtype(dt).itemsize


def _flop_factor(dt) -> float:
    """Complex GEMMs cost 4 real multiply-accumulate pairs per term."""
    if dt is None:
        return 1.0
    from ..ops._precision import as_torch_dtype
    return 4.0 if as_torch_dtype(dt).is_complex else 1.0


# ------------------------------------------------------------- comm models
def summa_comm_volume(N: int, K: int, M: int,
                      grid: Tuple[int, int]) -> Dict[str, float]:
    """Elements a rank receives per forward apply of each SUMMA schedule
    on padded tiles over a ``(pr, pc)`` grid (JAX ``:262-279``):
    ``{"gather", "stat_a", "adjoint"}``, :func:`summa_comm_volume_split`
    summed over the grid axes. ``schedule="auto"`` picks ``stat_a`` when
    it receives fewer than ``gather``."""
    split = summa_comm_volume_split(N, K, M, grid)
    return {k: v["r"] + v["c"] for k, v in split.items()}


def summa_comm_volume_split(N: int, K: int, M: int,
                            grid: Tuple[int, int]
                            ) -> Dict[str, Dict[str, float]]:
    """:func:`summa_comm_volume` by grid axis (JAX ``:282-311``).
    ``gather``: the A row along ``c``, the X column along ``r``;
    ``stat_a``: X fully, then the partial products reduce-scattered
    along ``c``; ``adjoint``: Y along ``c``, then a ring all-reduce over
    ``r`` (the port's reduce-scatter receives half of that)."""
    pr, pc = int(grid[0]), int(grid[1])
    Np = pr * math.ceil(N / pr)
    Kp_r = pr * math.ceil(K / pr)
    Kp_c = pc * math.ceil(K / pc)
    Mp = pc * math.ceil(M / pc)
    gather = {"c": (Np // pr) * Kp_c * (pc - 1) / pc,
              "r": Kp_r * (Mp // pc) * (pr - 1) / pr}
    stat_a = {"r": Kp_r * (Mp // pc) * (pr - 1) / pr,
              "c": (Kp_r * Mp * (pc - 1) / pc
                    + (Np // pr) * Mp * (pc - 1) / pc)}
    adjoint = {"c": (Np // pr) * Mp * (pc - 1) / pc,
               "r": (Kp_c // pc) * Mp * 2 * (pr - 1) / pr}
    return {"gather": gather, "stat_a": stat_a, "adjoint": adjoint}


def pencil_transpose_cost(shape: Tuple[int, ...], n_dev: int,
                          itemsize: int = 8,
                          n_transposes: int = 2,
                          fabric_shape: Optional[Tuple[int, int]] = None,
                          hierarchical: bool = False) -> OpCost:
    """Off-device cost of the distributed FFT's pencil transposes (JAX
    ``:314-368``): each all-to-all of the whole array moves ``(P-1)/P``
    of the local block; device memory reads and writes the local block
    once per transpose. ``fabric_shape=(D, I)`` splits the bytes over a
    two-level fabric of ``D`` groups of ``I`` devices (the two-level
    schedule with ``hierarchical``, the gather a flat all-to-all makes
    without it); ``None`` charges everything to ``ici_bytes``."""
    n_total = float(np.prod(shape))
    local_bytes = n_total * itemsize / max(n_dev, 1)
    frac = (n_dev - 1) / n_dev if n_dev > 1 else 0.0
    ici = local_bytes * frac * n_transposes
    dcn = 0.0
    notes = (f"pencil_transpose x{n_transposes}",)
    if fabric_shape is not None:
        d, i = int(fabric_shape[0]), int(fabric_shape[1])
        if d > 1 and i >= 1 and d * i == n_dev:
            if hierarchical:
                ici = local_bytes * (i - 1) / i * n_transposes
                dcn = local_bytes * (d - 1) / d * n_transposes
                notes = (f"pencil_transpose x{n_transposes} "
                         f"hier[dcn{d}xici{i}]",)
            else:
                ici = local_bytes * (i - 1) * n_transposes
                dcn = local_bytes * (n_dev - i) * n_transposes
                notes = (f"pencil_transpose x{n_transposes} "
                         f"flat-on-hybrid[dcn{d}xici{i}:gather]",)
    return OpCost(flops=0.0,
                  hbm_bytes=2.0 * local_bytes * n_transposes,
                  ici_bytes=ici, notes=notes, dcn_bytes=dcn)


# ------------------------------------------------------------ the registry
_REGISTRY: Dict[type, Callable] = {}
_DIRECTIONS = ("forward", "adjoint", "normal")


def register_cost(cls, fn: Callable) -> None:
    """Register ``fn(op, direction) -> OpCost`` for operator class
    ``cls``; subclasses resolve through the MRO, most derived first."""
    _REGISTRY[cls] = fn


def estimate(op, direction: str = "forward") -> Optional[OpCost]:
    """Per-rank cost of one ``direction`` apply of ``op`` (``forward``,
    ``adjoint``, or ``normal`` where a model has it), or ``None`` when
    no model applies: a missing model is unknown, never zero."""
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction={direction!r}")
    _bind_builtin()
    for cls in type(op).__mro__:
        fn = _REGISTRY.get(cls)
        if fn is not None:
            return fn(op, direction)
    return None


def _n_dev(op) -> int:
    """The ranks an operator spans: the process group's size."""
    from ..parallel.mesh import world_size
    return int(world_size())


def _cost_sparse_matmul(op, direction: str) -> Optional[OpCost]:
    """Sparse tier: operations and matrix bytes scale with ``nnz`` (value
    and two int32 indices a triplet); the adjoint adds the combine."""
    if direction == "normal":
        return None
    P = _n_dev(op)
    it_v = _itemsize(op.dtype)
    it_w = _itemsize(getattr(op, "compute_dtype", None) or op.dtype)
    ff = _flop_factor(op.dtype)
    flops = 2.0 * ff * op.nnz / P
    trip = op.nnz * (it_w + 8.0) / P
    if direction == "forward":
        vec = (op.Ncol + op.N / P) * it_v
        return OpCost(flops, trip + vec, 0.0, ("sparse.forward",))
    vec = (op.N + op.Ncol / P) * it_v
    ici = op.Ncol * it_v * 2.0 * (P - 1) / P
    return OpCost(flops, trip + vec, ici,
                  (f"sparse.adjoint+{op.adjoint_mode}",))


def _cost_block_matmul(op, direction: str) -> Optional[OpCost]:
    if direction == "normal":
        return None
    P = _n_dev(op)
    it_a = _itemsize(getattr(op, "compute_dtype", None) or op.dtype)
    it_v = _itemsize(op.dtype)
    ff = _flop_factor(op.dtype)
    flops = 2.0 * ff * op.N * op.K * op.M / P
    a_bytes = op.N * op.K * it_a / P
    if direction == "forward":
        vec = (op.K * op.M + op.N * op.M / P) * it_v
        return OpCost(flops, a_bytes + vec, 0.0, ("block.forward",))
    vec = (op.N * op.M / P + op.K * op.M) * it_v
    ici = op.K * op.M * it_v * 2.0 * (P - 1) / P
    return OpCost(flops, a_bytes + vec, ici, ("block.adjoint+psum",))


def _summa_fabric_split(bytes_r: float, bytes_c: float
                        ) -> Tuple[float, float, str]:
    """``(ici_bytes, dcn_bytes, note)`` of SUMMA's per-axis bytes (JAX
    ``:447-469``): on a flat world all on the links; on a world spanning
    hosts the port's grid has no host-aligned schedule yet (ROADMAP.md
    §A.3b), so, as the JAX package charges a topology-blind schedule,
    every byte may cross hosts and is charged to the slow fabric."""
    if _topo.world_shape() is None:
        return bytes_r + bytes_c, 0.0, ""
    return 0.0, bytes_r + bytes_c, "+fabric[blind:ib]"


def _cost_summa_matmul(op, direction: str) -> Optional[OpCost]:
    """SUMMA (JAX ``:472-501``), its bytes split by
    :func:`_summa_fabric_split`."""
    if direction == "normal":
        return None
    pr, pc = op.grid
    P = pr * pc
    Mp = pc * math.ceil(op.M / pc)
    it_a = _itemsize(getattr(op, "compute_dtype", None) or op.dtype)
    it_v = _itemsize(op.dtype)
    ff = _flop_factor(op.dtype)
    flops = 2.0 * ff * op.Np * op.Kp_c * Mp / P
    a_bytes = op.Np * op.Kp_c * it_a / P
    split = summa_comm_volume_split(op.N, op.K, op.M, op.grid)
    if direction == "forward":
        sched = getattr(op, "schedule", "gather")
        sp = split.get(sched, split["gather"])
        if sched == "gather":
            a_term = (op.Np // pr) * op.Kp_c * (pc - 1) / pc
            bytes_c = a_term * it_a + (sp["c"] - a_term) * it_v
        else:
            bytes_c = sp["c"] * it_v
        bytes_r = sp["r"] * it_v
        ici, dcn, fnote = _summa_fabric_split(bytes_r, bytes_c)
        vec = (op.Kp_r * Mp / P + op.Np * Mp / P) * it_v
        return OpCost(flops, a_bytes + vec, ici,
                      (f"summa.forward[{sched}]{fnote}",), dcn)
    sp = split["adjoint"]
    ici, dcn, fnote = _summa_fabric_split(sp["r"] * it_v, sp["c"] * it_v)
    vec = (op.Np * Mp / P + op.Kp_c * Mp / pc) * it_v
    return OpCost(flops, a_bytes + vec, ici, (f"summa.adjoint{fnote}",),
                  dcn)


def _cost_blockdiag(op, direction: str) -> OpCost:
    """Block diagonal (JAX ``:504-520``); ``normal``: ``(OpᴴOp x, Op x)``,
    the block stack read once through the normal kernel, twice through
    the two sweeps, x in and u, q out."""
    P = _n_dev(op)
    batched = getattr(op, "_batched", None)
    it_a = _itemsize(getattr(op, "compute_dtype", None) or op.dtype)
    it_v = _itemsize(op.dtype)
    ff = _flop_factor(op.dtype)
    if batched is not None:
        nblk, m, n = batched.shape
        k = getattr(op, "_batched_k", 1)
        flops = 2.0 * ff * nblk * m * n * k / P
        hbm = (nblk * m * n * it_a
               + (op.shape[0] + op.shape[1]) * it_v) / P
        if direction == "normal":
            sweeps = 1.0 if op.has_fused_normal else 2.0
            hbm = (sweeps * nblk * m * n * it_a
                   + (op.shape[0] + 2 * op.shape[1]) * it_v) / P
            return OpCost(2.0 * flops, hbm, 0.0,
                          (f"blockdiag.normal[{int(sweeps)} sweep]",))
        return OpCost(flops, hbm, 0.0, ("blockdiag.batched",))
    nm = float(np.sum(op.nops * op.mops))
    flops = 2.0 * ff * nm / P
    hbm = (nm * it_a + (op.shape[0] + op.shape[1]) * it_v) / P
    if direction == "normal":
        return OpCost(2.0 * flops, hbm + nm * it_a / P
                      + op.shape[1] * it_v / P, 0.0,
                      ("blockdiag.normal[2 sweep]",))
    return OpCost(flops, hbm, 0.0, ("blockdiag.per-block",))


def _cost_stack(op, direction: str) -> Optional[OpCost]:
    """The children summed, each applied once per apply (a lower bound:
    the batched adjoint's reduction is not counted)."""
    if direction == "normal":
        return None
    total = OpCost(notes=("stack.children-sum",))
    for child in getattr(op, "ops", ()):
        c = estimate(child, direction)
        if c is None:
            return None
        total = total + c
    return total


def _arg0(op):
    args = getattr(op, "args", None)
    return args[0] if args else op.A


def _cost_wrapper(op, direction: str) -> Optional[OpCost]:
    """Composition wrappers: adjoint/transpose swap direction; a product
    or sum adds its factors; scaled/conj/checkpointed forward; a power
    scales."""
    if direction == "normal":
        return None
    from ..linearoperator import (
        _AdjointLinearOperator, _TransposedLinearOperator,
        _ProductLinearOperator, _SumLinearOperator,
        _ScaledLinearOperator, _ConjLinearOperator,
        _PowerLinearOperator, _CheckpointedLinearOperator)
    flip = {"forward": "adjoint", "adjoint": "forward"}
    if isinstance(op, (_AdjointLinearOperator, _TransposedLinearOperator)):
        return estimate(_arg0(op), flip[direction])
    if isinstance(op, (_ProductLinearOperator, _SumLinearOperator)):
        a = estimate(op.args[0], direction)
        b = estimate(op.args[1], direction)
        return None if (a is None or b is None) else a + b
    if isinstance(op, (_ScaledLinearOperator, _ConjLinearOperator,
                       _CheckpointedLinearOperator)):
        return estimate(_arg0(op), direction)
    if isinstance(op, _PowerLinearOperator):
        c = estimate(op.args[0], direction)
        return None if c is None else c.scaled(op.args[1])
    return None


def _cost_fft(op, direction: str) -> Optional[OpCost]:
    """Pencil FFT (JAX ``:565-592``): ``5 n log2 n`` an axis over the
    local share, the transposes, and one read and write of the array."""
    if direction == "normal":
        return None
    dims = getattr(op, "dims_nd", None) or getattr(op, "dims", None)
    if not dims or any(d is None for d in dims):
        return None
    P = _n_dev(op)
    n_total = float(np.prod(dims))
    axes = tuple(int(a) for a in np.atleast_1d(
        getattr(op, "axes", tuple(range(len(dims))))))
    flops = sum(5.0 * n_total * math.log2(max(2, dims[ax]))
                for ax in axes) / P
    n_t = max(0, len(axes) - 1)
    # on a world spanning hosts: the flat all-to-all's gather (JAX
    # ``:582-583``; the port has no two-level schedule yet)
    cost = pencil_transpose_cost(dims, P, itemsize=8, n_transposes=n_t,
                                 fabric_shape=_topo.world_shape())
    return OpCost(flops, cost.hbm_bytes + 2 * n_total * 8 / P,
                  cost.ici_bytes, ("fft.pencil",) + cost.notes,
                  cost.dcn_bytes)


def _cost_derivative(op, direction: str) -> Optional[OpCost]:
    """Stencil (JAX ``:595-607``): 3 taps an entry, one read and one
    write, and the two ghost slabs over the links."""
    if direction == "normal":
        return None
    dims = getattr(op, "dims", None) or (op.shape[1],)
    P = _n_dev(op)
    n_total = float(np.prod(dims))
    it = _itemsize(op.dtype)
    taps = 3.0
    row = n_total / max(1, dims[0])
    w = 1
    ici = 2.0 * w * row * it if P > 1 else 0.0
    return OpCost(2.0 * taps * n_total / P, 2.0 * n_total * it / P, ici,
                  ("stencil.halo",))


def _cost_axis_derivative(op, direction: str) -> Optional[OpCost]:
    """A first derivative along axis ``op.axis`` (a part of
    ``MPIGradient``): axis 0 as :func:`_cost_derivative`, any other
    axis local to the rank's rows (no ghosts)."""
    c = _cost_derivative(op, direction)
    if c is None or getattr(op, "axis", 0) == 0:
        return c
    return OpCost(c.flops, c.hbm_bytes, 0.0, ("stencil.local",))


def _cost_gradient(op, direction: str) -> Optional[OpCost]:
    """``MPIGradient``: its axis derivatives summed (one forward apply
    reads the field once an axis and writes one output an axis)."""
    if direction == "normal":
        return None
    total = OpCost(notes=("gradient.axes-sum",))
    for child in op.Op.ops:
        c = estimate(child, direction)
        if c is None:
            return None
        total = total + c
    return total


# dotted name -> model, bound at the first estimate (importing the
# operator modules here would make an import cycle)
_BUILTIN = [
    ("pylops_mpi_tpu_torch.ops.matrixmult:_MPIBlockMatrixMult",
     _cost_block_matmul),
    ("pylops_mpi_tpu_torch.ops.matrixmult:_MPIAutoMatrixMult",
     _cost_block_matmul),
    ("pylops_mpi_tpu_torch.ops.matrixmult:_MPISummaMatrixMult",
     _cost_summa_matmul),
    ("pylops_mpi_tpu_torch.ops.sparse:MPISparseMatrixMult",
     _cost_sparse_matmul),
    ("pylops_mpi_tpu_torch.ops.blockdiag:MPIBlockDiag", _cost_blockdiag),
    ("pylops_mpi_tpu_torch.ops.stack:MPIVStack", _cost_stack),
    ("pylops_mpi_tpu_torch.ops.stack:MPIHStack", _cost_stack),
    ("pylops_mpi_tpu_torch.ops.fft:MPIFFTND", _cost_fft),
    ("pylops_mpi_tpu_torch.ops.fft:MPIFFT2D", _cost_fft),
    ("pylops_mpi_tpu_torch.ops.derivatives:MPIFirstDerivative",
     _cost_derivative),
    ("pylops_mpi_tpu_torch.ops.derivatives:MPISecondDerivative",
     _cost_derivative),
    ("pylops_mpi_tpu_torch.ops.derivatives:_AxisStencil",
     _cost_axis_derivative),
    ("pylops_mpi_tpu_torch.ops.derivatives:MPIGradient", _cost_gradient),
    ("pylops_mpi_tpu_torch.linearoperator:_AdjointLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_TransposedLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_ProductLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_SumLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_ScaledLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_ConjLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_PowerLinearOperator",
     _cost_wrapper),
    ("pylops_mpi_tpu_torch.linearoperator:_CheckpointedLinearOperator",
     _cost_wrapper),
]
_builtin_bound = False


def _bind_builtin() -> None:
    global _builtin_bound
    if _builtin_bound:
        return
    import importlib
    for dotted, fn in _BUILTIN:
        modname, clsname = dotted.split(":")
        try:
            cls = getattr(importlib.import_module(modname), clsname)
        except (ImportError, AttributeError):
            continue
        _REGISTRY.setdefault(cls, fn)
    _builtin_bound = True


# ---------------------------------------------------------------- roofline
def roofline(cost: OpCost, peaks: Dict, n_dev: int = 1,
             measured_s: Optional[float] = None) -> Dict:
    """Place an :class:`OpCost` on the roofline (JAX ``:664-729``): a
    time per component whose peak is known (``compute``, ``hbm``,
    ``ici``, ``dcn``, and the α term ``latency`` for costs that declare
    reductions), ``predicted_s`` the largest of them and ``bound`` its
    name; ``None`` when no peak is known. With ``measured_s``, an
    implied device-memory rate above the peak means the working set sat
    in the card's L2 (:data:`L2_BYTES`): ``regime="l2"`` and the ``hbm``
    component leaves the bound; otherwise ``regime="hbm"`` with
    ``hbm_pct``, the share of the peak rate the apply reached."""
    comps = {}
    if peaks.get("flops"):
        comps["compute"] = cost.flops / peaks["flops"]
    if peaks.get("hbm_gbps"):
        comps["hbm"] = cost.hbm_bytes / (peaks["hbm_gbps"] * 1e9)
    if peaks.get("ici_gbps") and cost.ici_bytes:
        comps["ici"] = cost.ici_bytes / (peaks["ici_gbps"] * 1e9)
    if peaks.get("dcn_gbps") and cost.dcn_bytes:
        comps["dcn"] = cost.dcn_bytes / (peaks["dcn_gbps"] * 1e9)
    if peaks.get("allreduce_latency_s") and cost.reductions_per_iter:
        comps["latency"] = (cost.reductions_per_iter
                            * peaks["allreduce_latency_s"])
    if not comps:
        return {"predicted_s": None, "bound": None, "components_s": {},
                "cost": cost.as_dict(), "n_dev": n_dev}
    bound = max(comps, key=comps.get)
    out = {"predicted_s": comps[bound], "bound": bound,
           "components_s": {k: float(f"{v:.4g}")
                            for k, v in comps.items()},
           "cost": cost.as_dict(), "n_dev": n_dev}
    if measured_s and measured_s > 0 and peaks.get("hbm_gbps") \
            and cost.hbm_bytes:
        implied_gbps = cost.hbm_bytes / measured_s / 1e9
        if implied_gbps > peaks["hbm_gbps"]:
            out["regime"] = "l2"
            out["implied_hbm_gbps"] = round(implied_gbps, 1)
            out["note"] = ("implied bandwidth exceeds the device-memory "
                           "peak: the working set was served from the "
                           f"{L2_BYTES >> 20} MB L2; not a device-memory "
                           "measurement")
            nonhbm = {k: v for k, v in comps.items() if k != "hbm"}
            if nonhbm:
                out["bound"] = max(nonhbm, key=nonhbm.get)
        else:
            out["regime"] = "hbm"
            out["hbm_pct"] = round(
                100.0 * implied_gbps / peaks["hbm_gbps"], 1)
    return out
