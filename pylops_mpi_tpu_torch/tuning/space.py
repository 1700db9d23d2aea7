"""Per-operator tuning spaces and their cost-model seeds.

PyTorch counterpart of ``pylops_mpi_tpu/tuning/space.py``: every space
and seed the JAX package registers, declared the same (the same axes,
candidates, enumerations, defaults and cost functions), so that
:func:`rank` orders a CPU context exactly as the JAX package does.

- **The cost-model pick equals today's defaults** on every platform:
  ``PYLOPS_MPI_TPU_TORCH_TUNE=on`` without a measured plan behaves as
  the untuned constructors (schedule by communication volume, the fused
  normal path where it applies). :func:`default_params` resolves
  ``overlap=auto`` as the constructors do: on for a card under an NCCL
  group of more than one rank, off otherwise. The seed assumes no
  transfer hidden behind compute (none is measured across cards yet),
  so its costs favour overlap off; where ``auto`` resolves on,
  :func:`rank` therefore keeps ``auto``'s overlap and chunk count first
  and lets the costs order only the other axes.
- **On the card only what changes the run is a candidate**
  (:func:`candidates`): in a world of one the pipelined collectives'
  ``overlap="on"`` candidates (and the chunk ladder they carry) are left
  out, as every ring and chunked schedule there runs the bulk one; SUMMA
  on a 1×1 grid, where every schedule runs the same GEMM, lists its
  default alone. In worlds of more than one rank the overlap candidates
  change what runs, and are listed. A family left with one candidate has
  nothing to measure. On the CPU the lists stay the JAX package's, for
  the parity tests.
- The port has no TPU: the JAX seeds' branches for it are not carried
  over. On a world laid out hosts × ranks (a context whose
  ``extra["topology"]`` is ``ib{D}xnvlink{I}``, JAX ``dcn{D}xici{I}``)
  the SUMMA and FFT seeds split their bytes by fabric, and their
  candidates are expanded along ``hierarchical`` (``on``, ``off``;
  :func:`_expand_hier`), ``auto``'s resolution (on there) ranked first;
  every other context keeps its candidate lists verbatim.
- **Peaks.** On the card (``platform="cuda"``) the seeds read
  :mod:`..diagnostics.costmodel`'s tables for the card (FP32 outside
  the tensor cores, device memory, NVLink); on the CPU the JAX
  package's assumed 30 GB/s carved over the devices.
- **Fixed axes** are recorded, never searched (the FFT engine, a tile).
- New operators register a space here rather than a new knob.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Axis", "TuningSpace", "space_for", "register_space",
           "candidates", "rank", "default_params", "SPACES"]


# per-collective dispatch overhead used by the seeds: the JAX package's
# figure for the CPU, and for the card a host launch of the order of ten
# microseconds (a placement figure: no transfer is assumed hidden behind
# device work until one is measured across cards)
_DISPATCH_S = {"cpu": 50e-6, "cuda": 10e-6}

# the families whose ``overlap`` (and ``comm_chunks``) select the
# pipelined collectives: in a world of one they run the bulk schedules
_COLLECTIVE_OVERLAP = ("matrixmult", "fft", "stack", "derivative", "halo")


@dataclass(frozen=True)
class Axis:
    """One tunable dimension: ``candidates`` in preference order
    (index 0 = today's default — ties in the cost seed keep this
    order, so an uninformative model degrades to current behavior).
    ``fixed`` axes are recorded in the plan but never searched."""

    name: str
    candidates: Tuple
    fixed: bool = False


@dataclass
class TuningSpace:
    """Declared plan space for one operator family.

    ``cost(context, params) -> Optional[float]`` predicts seconds for
    one apply under ``params`` (lower is better; ``None`` = no model,
    candidate keeps declaration order). ``enumerate_fn(context)``
    overrides the default cartesian product when candidates are
    conditional (e.g. ``comm_chunks`` only varies with overlap on).
    """

    op: str
    axes: Tuple[Axis, ...]
    cost: Optional[Callable[[Dict, Dict], Optional[float]]] = None
    enumerate_fn: Optional[Callable[[Dict], List[Dict]]] = None
    default_fn: Optional[Callable[[Dict], Dict]] = None
    note: str = ""

    def axis(self, name: str) -> Optional[Axis]:
        for ax in self.axes:
            if ax.name == name:
                return ax
        return None

    def validate(self, params: Dict) -> bool:
        """True when every (name, value) pair fits a declared axis —
        the gate a cached plan must pass before it is applied (a
        schema-valid cache can still carry a stale axis value after a
        code change; such entries are treated as misses)."""
        for k, v in params.items():
            ax = self.axis(k)
            if ax is None or v not in ax.candidates:
                return False
        return True


# ------------------------------------------------------------- cost seeds
def _peaks(context: Dict) -> Dict:
    """Roofline peaks for the seed: the card's data-sheet numbers; the
    JAX bench's assumed stream bandwidth carved across virtual devices
    on the CPU (the point is ORDERING candidates, not absolute
    prediction)."""
    nd = max(1, int(context.get("n_dev") or 1))
    if context.get("platform") == "cuda":
        from ..diagnostics import costmodel
        chip = context.get("chip") or ""
        return {"flops": costmodel.peak_flops(chip, "f32"),
                "hbm_gbps": costmodel.peak_hbm_gbps(chip),
                "ici_gbps": costmodel.peak_nvlink_gbps(chip),
                "dcn_gbps": costmodel.peak_dcn_gbps(chip)}
    # the CPU: the second fabric needs only the JAX package's ~9x ratio
    return {"flops": None, "hbm_gbps": 30.0 / nd, "ici_gbps": 30.0 / nd,
            "dcn_gbps": 30.0 / nd / 9.0}


def _fabric_of(context: Dict) -> Optional[Tuple[int, int]]:
    """``(hosts, ranks_per_host)`` from the context's
    ``extra["topology"]`` (``ib{D}xnvlink{I}``, set by ``plan.get_plan``
    on a world laid out hosts × ranks; JAX ``:119-131``), else ``None``,
    where every seed reads as on one host."""
    t = str(context.get("extra", {}).get("topology") or "")
    if t.startswith("ib") and "xnvlink" in t:
        try:
            d, i = t[2:].split("xnvlink")
            return int(d), int(i)
        except ValueError:
            return None
    return None


def _t_dcn(context: Dict, dcn_bytes: float) -> float:
    bw = _peaks(context).get("dcn_gbps")
    return dcn_bytes / (bw * 1e9) if (bw and dcn_bytes) else 0.0


def _dispatch_s(context: Dict) -> float:
    return _DISPATCH_S.get(context.get("platform"), _DISPATCH_S["cpu"])


def _itemsize(context: Dict) -> int:
    dt = context.get("dtype") or "float32"
    try:
        from ..ops._precision import as_torch_dtype
        return int(as_torch_dtype(dt).itemsize)
    except (TypeError, ValueError, AttributeError):
        return 4


def _overlap_seed(context: Dict, params: Dict, ici_bytes: float,
                  steps: int, base_s: float = 0.0) -> float:
    """Shared seed for the binary bulk-vs-pipelined choice: nothing is
    hidden behind compute (the JAX package hides half on the TPU alone;
    nothing is measured across cards) and each extra hop costs a
    dispatch, so ``on`` never ranks first on its cost. Where
    ``overlap=auto`` resolves on, :func:`rank` keeps it first all the
    same, so the seed's pick stays the constructors' default."""
    pk = _peaks(context)
    t_ici = (ici_bytes / (pk["ici_gbps"] * 1e9)
             if pk.get("ici_gbps") and ici_bytes else 0.0)
    if params.get("overlap") != "on":
        return base_s + t_ici
    return base_s + t_ici + max(0, steps) * _dispatch_s(context)


def _batch_of(context: Dict) -> int:
    """Block width of the solve the plan will serve (``extra["batch"]``,
    default 1). Seeds scale their per-apply work by it — K columns ride
    the same schedule — so batch=1 costs (and therefore batch=1 plans)
    are EXACTLY the pre-batching ones."""
    try:
        return max(1, int(context.get("extra", {}).get("batch") or 1))
    except (TypeError, ValueError):
        return 1


def _cost_matrixmult(context: Dict, params: Dict) -> Optional[float]:
    shape = context.get("shape")
    if not shape or len(shape) != 3:
        return None
    N, K, M = (int(s) for s in shape)
    M *= _batch_of(context)  # K RHS columns widen the model dimension
    grid = tuple(context.get("extra", {}).get("grid") or (1, 1))
    pr, pc = max(1, int(grid[0])), max(1, int(grid[1]))
    P = pr * pc
    it = _itemsize(context)
    from ..diagnostics.costmodel import summa_comm_volume_split
    split = summa_comm_volume_split(N, K, M, (pr, pc))
    sp = split.get(params.get("schedule", "gather"), split["gather"])
    fab = _fabric_of(context)
    if fab is None:
        ici_b, dcn_b = (sp["r"] + sp["c"]) * it, 0.0
    elif params.get("hierarchical") == "off":
        # with the two-level schedules off every byte may cross hosts
        # (costmodel._summa_fabric_split's blind charge)
        ici_b, dcn_b = 0.0, (sp["r"] + sp["c"]) * it
    else:
        ici_b, dcn_b = sp["c"] * it, sp["r"] * it
    pk = _peaks(context)
    flops = 2.0 * N * K * M / P
    hbm = (N * K + K * M + N * M) * it / P
    t_comp = flops / pk["flops"] if pk.get("flops") else 0.0
    t_hbm = hbm / (pk["hbm_gbps"] * 1e9) if pk.get("hbm_gbps") else 0.0
    return _overlap_seed(context, params, ici_b, steps=pc - 1,
                         base_s=max(t_comp, t_hbm)) + _t_dcn(context, dcn_b)


def _cost_fft(context: Dict, params: Dict) -> Optional[float]:
    shape = context.get("shape")
    if not shape:
        return None
    P = max(1, int(context.get("n_dev") or 1))
    it = _itemsize(context)
    n_total = float(np.prod([int(s) for s in shape]))
    from ..diagnostics.costmodel import pencil_transpose_cost
    c = pencil_transpose_cost(tuple(int(s) for s in shape), P,
                              itemsize=it, fabric_shape=_fabric_of(context),
                              hierarchical=params.get("hierarchical")
                              != "off")
    pk = _peaks(context)
    flops = 5.0 * n_total * math.log2(max(2.0, n_total)) / P
    t_comp = flops / pk["flops"] if pk.get("flops") else 0.0
    t_hbm = (c.hbm_bytes / (pk["hbm_gbps"] * 1e9)
             if pk.get("hbm_gbps") else 0.0)
    pk_ici = pk.get("ici_gbps")
    t_ici = c.ici_bytes / (pk_ici * 1e9) if pk_ici else 0.0
    K = int(params.get("comm_chunks", 1))
    # nothing hides behind the per-chunk transforms; each chunk adds one
    # all-to-all dispatch pair per transpose
    base = max(t_comp, t_hbm) + _t_dcn(context, c.dcn_bytes)
    if params.get("overlap") != "on" or K <= 1:
        return base + t_ici
    return base + t_ici + 2 * (K - 1) * _dispatch_s(context)


def _cost_blockdiag(context: Dict, params: Dict) -> Optional[float]:
    extra = context.get("extra", {})
    a_bytes = float(extra.get("a_bytes") or 0.0)
    if not a_bytes:
        return None
    P = max(1, int(context.get("n_dev") or 1))
    pk = _peaks(context)
    # the normal-equation apply is bound by device memory: the fused
    # path (the normal kernel) streams the block stack ONCE per (u, q)
    # pair, the two sweeps twice — the whole reason the kernel exists
    sweeps = 1.0 if params.get("normal_path") == "fused" else 2.0
    # the block stack streams ONCE for all K columns (the batching
    # amortization); only the per-column vector traffic scales, which
    # the seed folds in as a small linear term so batch=1 is unchanged
    b = _batch_of(context)
    if not pk.get("hbm_gbps"):
        return sweeps
    return sweeps * a_bytes * (1.0 + 0.01 * (b - 1)) / P \
        / (pk["hbm_gbps"] * 1e9)


def _cost_stack(context: Dict, params: Dict) -> Optional[float]:
    shape = context.get("shape")
    if not shape:
        return None
    P = max(1, int(context.get("n_dev") or 1))
    it = _itemsize(context)
    out_len = int(shape[-1]) * _batch_of(context)
    ici = out_len * it * 2.0 * (P - 1) / max(1, P)  # adjoint psum
    return _overlap_seed(context, params, ici, steps=P - 1)


def _cost_halo_family(context: Dict, params: Dict) -> Optional[float]:
    shape = context.get("shape")
    if not shape:
        return None
    P = max(1, int(context.get("n_dev") or 1))
    it = _itemsize(context)
    row = float(np.prod([int(s) for s in shape])) / max(1, int(shape[0]))
    ici = 2.0 * row * it if P > 1 else 0.0  # two ghost slabs
    return _overlap_seed(context, params, ici, steps=2)


def _one_tile(context: Dict) -> bool:
    grid = tuple(context.get("extra", {}).get("grid") or (1, 1))
    return int(np.prod([max(1, int(g)) for g in grid])) == 1


def _hier_auto(context: Dict) -> Optional[str]:
    """``hierarchical=auto``'s resolution where the context spans hosts:
    ``"on"`` (auto is on exactly on a world laid out hosts × ranks,
    ``utils.deps.hierarchical_enabled``), else ``None``."""
    return "on" if _fabric_of(context) else None


def _expand_hier(cands: List[Dict], context: Dict) -> List[Dict]:
    """The candidates expanded along ``hierarchical`` (``on``, ``off``),
    only where the context carries a hosts × ranks topology (JAX
    ``:290-303``): a flat world has nothing to stage, so its lists, keys
    and budgets stay as they were."""
    if not _fabric_of(context):
        return cands
    return [dict(p, hierarchical=h) for p in cands for h in ("on", "off")]


def _enum_matrixmult(context: Dict) -> List[Dict]:
    if context.get("platform") == "cuda" and _one_tile(context):
        # one tile: every schedule runs the same GEMM
        return [_default_matrixmult(context)]
    return _expand_hier([{"schedule": s, "overlap": o}
                         for s in ("gather", "stat_a")
                         for o in ("off", "on")], context)


def _enum_fft(context: Dict) -> List[Dict]:
    """Overlap off makes the chunk count moot — one canonical bulk
    candidate plus the chunked ladder, instead of a product full of
    aliases that would waste measurement trials."""
    from ..utils.deps import comm_chunks_default
    ladder = []
    seen = set()
    for k in (comm_chunks_default(), 2, 4, 8):
        if k > 1 and k not in seen:
            seen.add(k)
            ladder.append({"overlap": "on", "comm_chunks": int(k)})
    return _expand_hier([{"overlap": "off", "comm_chunks": 1}] + ladder,
                        context)


def _enum_blockdiag(context: Dict) -> List[Dict]:
    if context.get("extra", {}).get("fused_available"):
        return [{"normal_path": "fused"}, {"normal_path": "two_sweep"}]
    return [{"normal_path": "two_sweep"}]


# --------------------------------------------------------------- registry
SPACES: Dict[str, TuningSpace] = {}


def register_space(space: TuningSpace) -> None:
    """Register (or replace) the tuning space for one operator family
    — the extension point new kernels use instead of a new env knob."""
    SPACES[space.op] = space


def space_for(op: str) -> Optional[TuningSpace]:
    return SPACES.get(op)


def candidates(space: TuningSpace, context: Optional[Dict] = None) \
        -> List[Dict]:
    """Searchable candidate param dicts (fixed axes excluded), in
    declaration order — index 0 is today's default configuration. On
    the card in a world of one a pipelined collective's
    ``overlap="on"`` candidate is left out: every ring and chunked
    schedule runs the bulk one there, so timing it would race an
    alias."""
    context = context or {}
    if space.enumerate_fn is not None:
        out = [dict(p) for p in space.enumerate_fn(context)]
    else:
        out = [{}]
        for ax in space.axes:
            if ax.fixed:
                continue
            out = [dict(p, **{ax.name: c}) for p in out
                   for c in ax.candidates]
    if (context.get("platform") == "cuda" and space.op in _COLLECTIVE_OVERLAP
            and int(context.get("n_dev") or 1) <= 1):
        out = [p for p in out if p.get("overlap", "off") == "off"]
    return out


def _auto_on(context: Dict) -> bool:
    """``overlap=auto`` as the constructors resolve it for this context
    (``utils.deps.overlap_enabled``): a card, more than one rank, and the
    live group NCCL (the context does not carry the backend)."""
    if context.get("platform") != "cuda" \
            or int(context.get("n_dev") or 1) <= 1:
        return False
    from ..utils import deps
    return deps.overlap_auto()


def default_params(space: TuningSpace, context: Optional[Dict] = None) \
        -> Dict:
    """The candidate matching current (pre-tuner) behavior — the race
    baseline the acceptance bar compares against. ``default_fn`` wins
    when declared (matrixmult: ``schedule="auto"`` IS the comm-volume
    pick, not a fixed value); otherwise first in declaration order, with
    ``overlap=auto`` resolved as the constructors resolve it (on for a
    card under an NCCL group of several ranks: the first candidate that
    carries it; JAX ``:360-380``), and where the context spans hosts
    ``hierarchical=auto`` resolved too."""
    context = context or {}
    if space.default_fn is not None:
        return dict(space.default_fn(context))
    cands = candidates(space, context)
    want = {}
    if "overlap" in cands[0] and space.op in _COLLECTIVE_OVERLAP \
            and _auto_on(context):
        want["overlap"] = "on"
    hier = _hier_auto(context)
    if hier is not None and "hierarchical" in cands[0]:
        want["hierarchical"] = hier
    for c in cands:
        if all(c.get(k) == v for k, v in want.items()):
            return dict(c)
    return dict(cands[0])


def rank(space: TuningSpace, context: Dict) -> List[Dict]:
    """Candidates ordered by the cost seed (stable sort: ties keep
    declaration order, i.e. the default first). Where ``overlap=auto``
    resolves on (a card under an NCCL group of several ranks), the
    candidates with the default's ``overlap`` and ``comm_chunks`` come
    first: the seed prices no hidden transfer, so on its costs alone it
    would rank off first against the constructors' default. Where the
    context spans hosts, the candidates with ``hierarchical=auto``'s
    resolution come first likewise."""
    cands = candidates(space, context)
    if space.cost is None:
        return cands
    keep = {}
    if space.op in _COLLECTIVE_OVERLAP and _auto_on(context):
        d = default_params(space, context)
        keep = {k: d[k] for k in ("overlap", "comm_chunks") if k in d}
    hier = _hier_auto(context)
    if hier is not None and any("hierarchical" in p for p in cands):
        keep["hierarchical"] = hier
    scored = []
    for i, p in enumerate(cands):
        try:
            c = space.cost(context, p)
        except Exception:
            c = None
        other = any(p.get(k) != v for k, v in keep.items())
        scored.append((other, c if c is not None else float("inf"), i, p))
    scored.sort(key=lambda t: t[:3])
    return [t[3] for t in scored]


def _default_matrixmult(context: Dict) -> Dict:
    """Today's ``schedule="auto"`` resolution: the comm-volume pick
    (ops/matrixmult.py) — what an untuned construction would run."""
    shape = context.get("shape") or (1, 1, 1)
    grid = tuple(context.get("extra", {}).get("grid") or (1, 1))
    from ..diagnostics.costmodel import summa_comm_volume
    vols = summa_comm_volume(int(shape[0]), int(shape[1]),
                             int(shape[2]), grid)
    out = {"schedule": ("stat_a" if vols["stat_a"] < vols["gather"]
                        else "gather"),
           "overlap": "on" if _auto_on(context) else "off"}
    hier = _hier_auto(context)
    if hier is not None:
        out["hierarchical"] = hier
    return out


register_space(TuningSpace(
    op="matrixmult",
    axes=(Axis("schedule", ("gather", "stat_a")),
          Axis("overlap", ("off", "on")),
          Axis("hierarchical", ("auto", "on", "off")),
          Axis("comm_chunks", (1,), fixed=True),
          Axis("batch", (1, 2, 4, 8, 16, 32, 64), fixed=True)),
    cost=_cost_matrixmult,
    default_fn=_default_matrixmult,
    enumerate_fn=_enum_matrixmult,
    note="SUMMA forward schedule x ring overlap x (hybrid meshes only) "
         "hierarchical staging; chunking is carried by the ring step "
         "count, recorded for provenance only; batch is the solve's "
         "block width (keyed, never searched)"))

register_space(TuningSpace(
    op="fft",
    axes=(Axis("overlap", ("off", "on")),
          Axis("comm_chunks", (1, 2, 4, 8)),
          Axis("hierarchical", ("auto", "on", "off")),
          Axis("engine", ("resolved",), fixed=True)),
    cost=_cost_fft,
    enumerate_fn=_enum_fft,
    note="pencil-transpose chunking x (hybrid meshes only) two-level "
         "staging; the planar/complex engine is the global "
         "complex engine (the port has no planar mode) — recorded "
         "in the plan, never flipped by the tuner"))

def _cost_sparse_tier(context: Dict, params: Dict) -> Optional[float]:
    """Dense-vs-sparse matmul tier seed: both tiers priced on the
    roofline (flops when a peak is known, always bytes). The sparse
    tier streams ``nnz`` triplets (value + two int32 indices); the
    dense tier streams the full ``N·M`` matrix — the crossover sits
    near ``nnz ≈ N·M·it/(it+8)`` (≈ N·M/3 at f32), so ≥90% sparsity
    picks sparse with a wide margin."""
    shape = context.get("shape") or (1, 1)
    N, M = int(shape[0]), int(shape[1])
    extra = context.get("extra") or {}
    nnz = int(extra.get("nnz") or N * M)
    it = int(extra.get("itemsize") or 4)
    nd = max(1, int(context.get("n_dev") or 1))
    pk = _peaks(context)
    bw = (pk.get("hbm_gbps") or 30.0) * 1e9
    if params.get("tier") == "sparse":
        bytes_ = nnz * (it + 8.0) / nd + (N + M) * it
        flops = 2.0 * nnz / nd
    else:
        bytes_ = N * M * float(it) / nd + (N + M) * it
        flops = 2.0 * N * M / nd
    t = bytes_ / bw
    if pk.get("flops"):
        t = max(t, flops / pk["flops"])
    return t


register_space(TuningSpace(
    op="sparse_matmult",
    axes=(Axis("tier", ("dense", "sparse")),),
    cost=_cost_sparse_tier,
    note="matmul storage tier: dense GEMM (MPIMatrixMult) vs nnz-"
         "scaled gather/segment-sum (MPISparseMatrixMult); nnz rides "
         "in the plan key's extra so the same logical shape can "
         "resolve differently per sparsity — tuning off always means "
         "dense (the bit-identity pin)"))

register_space(TuningSpace(
    op="blockdiag",
    axes=(Axis("normal_path", ("fused", "two_sweep")),
          Axis("tile", ("kernel_default",), fixed=True),
          Axis("batch", (1, 2, 4, 8, 16, 32, 64), fixed=True)),
    cost=_cost_blockdiag,
    enumerate_fn=_enum_blockdiag,
    note="fused (the one-sweep normal kernel, csrc/normal_matvec.cu) "
         "vs two-sweep normal equations; the kernel's plan is its own "
         "(ops/normal_kernels.plan), recorded for provenance"))

register_space(TuningSpace(
    op="stack",
    axes=(Axis("overlap", ("off", "on")),
          Axis("batch", (1, 2, 4, 8, 16, 32, 64), fixed=True)),
    cost=_cost_stack,
    note="batched adjoint reduction: partitioner psum vs explicit "
         "ring reduce-scatter"))

register_space(TuningSpace(
    op="derivative",
    axes=(Axis("overlap", ("off", "on")),),
    cost=_cost_halo_family,
    note="ghost strategy: bulk halo-extend vs interior/boundary split "
         "with in-flight ghost ppermutes"))

register_space(TuningSpace(
    op="halo",
    axes=(Axis("overlap", ("off", "on")),),
    cost=_cost_halo_family,
    note="repack from the pre-exchange block (select-merged) vs the "
         "post-exchange extended block"))

register_space(TuningSpace(
    op="pencil_transpose",
    axes=(Axis("comm_chunks", (1, 2, 4, 8)),),
    cost=None,
    note="standalone chunk-count plans consumed by "
         "collectives.resolve_chunks for default-chunked transposes"))

register_space(TuningSpace(
    op="reshard",
    axes=(Axis("comm_chunks", (1, 2, 4, 8)),),
    cost=None,
    note="chunk counts for the bounded-memory resharding planner "
         "(parallel/reshard.py); the budget sets the floor, a banked "
         "plan can only stream finer"))

register_space(TuningSpace(
    op="spill",
    axes=(Axis("comm_chunks", (1, 2, 4, 8)),
          Axis("overlap", ("on", "off"))),
    cost=None,
    note="host-staging schedules of the spill tier "
         "(parallel/spill.py): chunk counts for the budget-sized "
         "device_get/device_put stream and the double-buffer overlap "
         "choice (on = fetch of chunk k+1 rides behind the placement "
         "of chunk k); the budget stays the floor on chunk counts"))


def _cost_ca(context: Dict, params: Dict) -> Optional[float]:
    """Latency-aware (α–β) seed for the communication-avoiding solver
    tier (solvers/ca.py): per-iteration time = operator-apply stream
    term (β, bytes/bandwidth) + all-reduce count x per-fabric latency
    floor (α, costmodel.ALLREDUCE_LATENCY_S). Classic CG pays 2
    sequential reductions; the pipelined engine pays ONE, issued
    before the apply so it hides behind it (max, not sum); s-step
    pays 1/s reductions but (2s-1)/s applies for the combined basis
    plus a conditioning-risk penalty growing with s."""
    from ..diagnostics.costmodel import allreduce_latency_s
    from ..solvers.ca import classic_reductions_per_iter
    mode = params.get("mode", "off")
    s = max(1, int(params.get("s", 1) or 1))
    fabric = "nccl" if context.get("platform") == "cuda" else "host"
    lat = (allreduce_latency_s(fabric) or 0.0) + _dispatch_s(context)
    extra = context.get("extra", {})
    a_bytes = float(extra.get("a_bytes") or 0.0)
    pk = _peaks(context)
    nd = max(1, int(context.get("n_dev") or 1))
    t_apply = (a_bytes / nd / (pk["hbm_gbps"] * 1e9)
               if (a_bytes and pk.get("hbm_gbps")) else 0.0)
    solver = str(extra.get("solver") or "cg")
    try:
        red = float(classic_reductions_per_iter(solver))
    except KeyError:
        red = 2.0
    if mode == "off":
        return t_apply + red * lat
    if mode == "pipelined":
        # one reduction in flight behind the apply; the extra vector
        # recurrences add a small stream term
        return max(t_apply, lat) + 0.05 * t_apply
    # sstep: amortized latency, inflated basis work, breakdown risk
    return (t_apply * (2.0 * s - 1.0) / s + lat / s
            + 0.02 * (s - 1) * t_apply)


def _enum_ca(context: Dict) -> List[Dict]:
    """``s`` only varies under ``mode="sstep"`` — off/pipelined carry
    the canonical ``s=1`` so the candidate list (and the measurement
    budget) has no aliased trials."""
    return ([{"mode": "off", "s": 1}, {"mode": "pipelined", "s": 1}]
            + [{"mode": "sstep", "s": k} for k in (2, 4, 8)])


register_space(TuningSpace(
    op="ca",
    axes=(Axis("mode", ("off", "pipelined", "sstep")),
          Axis("s", (1, 2, 4, 8))),
    cost=_cost_ca,
    enumerate_fn=_enum_ca,
    note="communication-avoiding Krylov engine selection "
         "(solvers/ca.py): classic per-iteration reductions vs the "
         "single-stacked-reduction pipelined engine vs the s-step "
         "basis with one Gram reduction per s iterations; index 0 = "
         "off keeps the bit-identity default, PYLOPS_MPI_TPU_TORCH_CA "
         "overrides any plan"))
