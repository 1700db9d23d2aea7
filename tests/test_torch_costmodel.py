"""The port's cost model (``pylops_mpi_tpu_torch.diagnostics.costmodel``)
held against the JAX package's on the same operators and inputs.

- ``estimate`` of every family both packages model: the port's
  operators at a world of one against the JAX operators on a mesh of one
  device, built from the same numpy data (seed 7); the whole ``OpCost``
  (operations, bytes, notes) equal exactly.
- ``summa_comm_volume``/``_split`` and ``pencil_transpose_cost`` equal
  exactly over several grids and device counts; ``roofline`` equal on
  the same peak dicts (the JAX ``vmem`` regime is the port's ``l2``).
- The card's peak table: H100 names resolve, an unknown card gets None;
  ``device_peaks`` on the CPU equals the JAX package's off-TPU dict.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.diagnostics import costmodel as jcm
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu.parallel.mesh import make_mesh
from pylops_mpi_tpu_torch.diagnostics import costmodel as tcm
from pylops_mpi_tpu_torch.ops.local import MatrixMult as TMatrixMult


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return {"blocks": [rng.standard_normal((12, 10)) for _ in range(4)],
            "A": rng.standard_normal((24, 20)),
            "sp": np.where(rng.random((30, 16)) < 0.2,
                           rng.standard_normal((30, 16)), 0.0),
            "sq": [rng.standard_normal((10, 10)) for _ in range(4)]}


def _pairs(d):
    """(name, jax operator, port operator) of every modelled family."""
    m1 = make_mesh(1)
    bl, sq = d["blocks"], d["sq"]
    f32 = [b.astype(np.float32) for b in bl]
    out = [
        ("blockdiag", pmt.MPIBlockDiag([JMatrixMult(b) for b in bl],
                                       mesh=m1),
         pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in bl])),
        ("blockdiag_f32", pmt.MPIBlockDiag([JMatrixMult(b) for b in f32],
                                           mesh=m1),
         pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in f32])),
        ("vstack", pmt.MPIVStack([JMatrixMult(b) for b in bl], mesh=m1),
         pmtt.MPIVStack([TMatrixMult(b, device="cpu") for b in bl])),
        ("hstack", pmt.MPIHStack([JMatrixMult(b) for b in bl], mesh=m1),
         pmtt.MPIHStack([TMatrixMult(b, device="cpu") for b in bl])),
        ("fftnd", pmt.MPIFFTND((8, 6, 4), mesh=m1),
         pmtt.MPIFFTND((8, 6, 4))),
        ("fft2d", pmt.MPIFFT2D((16, 8), mesh=m1), pmtt.MPIFFT2D((16, 8))),
        ("first", pmt.MPIFirstDerivative((16, 5), mesh=m1),
         pmtt.MPIFirstDerivative((16, 5))),
        ("second", pmt.MPISecondDerivative((16, 5), mesh=m1),
         pmtt.MPISecondDerivative((16, 5))),
        ("sparse", pmt.MPISparseMatrixMult.from_dense(d["sp"], mesh=m1),
         pmtt.MPISparseMatrixMult.from_dense(d["sp"], device="cpu")),
    ]
    for sched in ("gather", "stat_a"):
        out.append((f"summa_{sched}",
                    pmt.MPIMatrixMult(d["A"], 3, kind="summa", mesh=m1,
                                      schedule=sched),
                    pmtt.MPIMatrixMult(d["A"], 3, kind="summa",
                                       schedule=sched, device="cpu")))
    out.append(("block_mm", pmt.MPIMatrixMult(d["A"], 3, kind="block",
                                              mesh=m1),
                pmtt.MPIMatrixMult(d["A"], 3, kind="block", device="cpu")))
    jsq = pmt.MPIBlockDiag([JMatrixMult(b) for b in sq], mesh=m1)
    tsq = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in sq])
    jbd, tbd = out[0][1], out[0][2]
    out += [("adjoint", jbd.H, tbd.H),
            ("product", jsq * jsq, tsq * tsq),
            ("sum", jsq + jsq, tsq + tsq),
            ("scaled", 2.5 * jsq, 2.5 * tsq),
            ("conj", jsq.conj(), tsq.conj()),
            ("power", jsq ** 3, tsq ** 3)]
    return out


# stacks of local operators: neither package models the local rows
_UNKNOWN = {"vstack", "hstack"}


def test_estimate_equals_jax_per_family(data):
    for name, jop, top in _pairs(data):
        for direction in ("forward", "adjoint"):
            j = jcm.estimate(jop, direction)
            t = tcm.estimate(top, direction)
            if name in _UNKNOWN:
                assert j is None and t is None, (name, direction)
                continue
            assert j is not None and t is not None, (name, direction)
            assert t.as_dict() == j.as_dict(), (name, direction)


def test_unknown_operator_and_port_extensions(data):
    class Bare(pmtt.MPILinearOperator):
        pass
    assert tcm.estimate(Bare(shape=(3, 3), dtype=torch.float64)) is None
    with pytest.raises(ValueError):
        tcm.estimate(Bare(shape=(3, 3)), "sideways")
    # MPIGradient (no JAX model): the sum of its axis derivatives, the
    # field read and written once an axis
    g = tcm.estimate(pmtt.MPIGradient((16, 8), dtype=torch.float32))
    assert g.hbm_bytes == 2 * 2 * 16 * 8 * 4 and g.ici_bytes == 0.0
    # the normal apply: the stack read once through the kernel, twice
    # through the two sweeps
    bl = [b.astype(np.float32) for b in data["blocks"]]
    fused = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in bl])
    two = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in bl],
                            normal_path="two_sweep")
    a = 4 * 12 * 10 * 4
    nf = tcm.estimate(fused, "normal")
    nt = tcm.estimate(two, "normal")
    assert nt.hbm_bytes - nf.hbm_bytes == a
    assert nf.flops == 2 * tcm.estimate(fused).flops


@pytest.mark.parametrize("grid", [(1, 1), (1, 2), (2, 2), (2, 3), (3, 2),
                                  (4, 2)])
def test_summa_volume_equals_jax(grid):
    for shape in [(24, 20, 3), (4096, 2048, 64), (17, 13, 5)]:
        assert tcm.summa_comm_volume(*shape, grid) == \
            jcm.summa_comm_volume(*shape, grid)
        assert tcm.summa_comm_volume_split(*shape, grid) == \
            jcm.summa_comm_volume_split(*shape, grid)
    from pylops_mpi_tpu_torch.ops import matrixmult as tmm
    assert tmm.summa_comm_volume is tcm.summa_comm_volume


@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_pencil_transpose_equals_jax(P):
    for shape, it, nt in [((64, 32), 8, 2), ((16, 16, 8), 16, 1),
                          ((30, 7), 4, 3)]:
        for fab, hier in [(None, False), ((2, P // 2), True),
                          ((2, P // 2), False)]:
            if fab is not None and P % 2:
                continue
            j = jcm.pencil_transpose_cost(shape, P, it, nt, fab, hier)
            t = tcm.pencil_transpose_cost(shape, P, it, nt, fab, hier)
            assert t.as_dict() == j.as_dict()


def test_roofline_equals_jax():
    peaks = [{"flops": 67e12, "hbm_gbps": 3350.0, "ici_gbps": 450.0,
              "dcn_gbps": None, "allreduce_latency_s": 3e-4},
             {"flops": None, "hbm_gbps": 30.0, "ici_gbps": 30.0,
              "dcn_gbps": 3.3, "allreduce_latency_s": 2e-5},
             {"flops": None, "hbm_gbps": None, "ici_gbps": None,
              "dcn_gbps": None, "allreduce_latency_s": None}]
    costs = [jcm.OpCost(2e9, 2.1e9, 0.0), jcm.OpCost(1e12, 1e6, 5e8),
             jcm.OpCost(0.0, 1e8, 2e7, ("x",), 4e6, 5.0)]
    for pk in peaks:
        for c in costs:
            tc = tcm.OpCost(c.flops, c.hbm_bytes, c.ici_bytes, c.notes,
                            c.dcn_bytes, c.reductions_per_iter)
            for P in (1, 4):
                for meas in (None, 1.0):  # 1 s: well below any peak
                    assert tcm.roofline(tc, pk, P, meas) == \
                        jcm.roofline(c, pk, P, meas)
    # above the device-memory peak: the JAX "vmem" regime is the L2 here
    c = jcm.OpCost(0.0, 1e9, 0.0)
    j = jcm.roofline(c, peaks[0], 1, 1e-7)
    t = tcm.roofline(tcm.OpCost(0.0, 1e9, 0.0), peaks[0], 1, 1e-7)
    assert j["regime"] == "vmem" and t["regime"] == "l2"
    assert t["implied_hbm_gbps"] == j["implied_hbm_gbps"]
    assert "hbm_pct" not in t and t["predicted_s"] == j["predicted_s"]


def test_card_tables_and_cpu_peaks():
    for name in ("NVIDIA H100 80GB HBM3", "NVIDIA H100 SXM5 80GB"):
        assert tcm.peak_hbm_gbps(name) == 3350.0
        assert tcm.peak_flops(name, "f32") == 67e12
        assert tcm.peak_flops(name, "tf32") == 494.5e12
        assert tcm.peak_flops(name, "bf16") == 989.5e12
        assert tcm.peak_nvlink_gbps(name) == 450.0
    assert tcm.peak_hbm_gbps("NVIDIA H100 PCIe") == 2000.0
    for unknown in ("NVIDIA A100-SXM4-80GB", "", "cpu"):
        assert tcm.peak_hbm_gbps(unknown) is None
        assert tcm.peak_flops(unknown) is None
    import jax
    j = jcm.device_peaks(jax.devices("cpu")[0])
    t = tcm.device_peaks(torch.device("cpu"))
    assert t == j
    assert tcm.allreduce_latency_s("host") == jcm.allreduce_latency_s("host")
    assert tcm.allreduce_latency_s("bogus") is None
    # no process group: nothing to measure
    assert tcm.measure_allreduce_latency() is None
