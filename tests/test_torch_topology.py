"""The port's fabric topology held against the JAX package's.

The port's ``nvlink``/``ib`` are the JAX package's ``ici``/``dcn``, a
host is its slice, and ``PYLOPS_MPI_TPU_TORCH_FABRIC="DxI"`` declares D
hosts of I ranks as ``PYLOPS_MPI_TPU_FABRIC`` declares D slices of I
devices. Host-only: the override's parsing and its malformed values;
``axis_fabric``, ``mesh_fabrics``, ``is_hybrid``, ``hybrid_axes``,
``topology_key``, ``collective_fabric``, ``slice_map``, ``slice_run``
and ``perm_crossings`` on the same layouts (a 2-D grid of ranks against
a JAX mesh of as many devices, row-major); an empty key for a flat
layout; the per-fabric byte counters; the IB peak of the cost model and
the pencil transposes' split.

On a gloo world of 4 ranks (spawned once): ``make_mesh_hybrid`` on one
host (one row, no per-fabric counter, plan keys as before) and under
``FABRIC=2x2`` (a 2x2 grid; an all-reduce over the world counted in
``.bytes_ib``, over a host's ranks in ``.bytes_nvlink``; the plan key
and the compile signature carry ``ib2xnvlink2``), and its error for a
``dcn_size`` that does not divide the world.
"""

import numpy as np
import pytest
import torch

from pylops_mpi_tpu.parallel import topology as jtopo
from pylops_mpi_tpu_torch.diagnostics import costmodel as tcm
from pylops_mpi_tpu_torch.diagnostics import metrics
from pylops_mpi_tpu_torch.parallel import topology as ttopo
from pylops_mpi_tpu_torch.parallel.mesh import Grid2D, Mesh

from test_torch_process_group import run_world
from torch_reshard_ranks import topology_rank

TENV, JENV = "PYLOPS_MPI_TPU_TORCH_FABRIC", "PYLOPS_MPI_TPU_FABRIC"
FAB = {"ici": "nvlink", "dcn": "ib"}


def _both(monkeypatch, raw):
    monkeypatch.setenv(TENV, raw)
    monkeypatch.setenv(JENV, raw)


def _jmesh(shape, names):
    import jax
    from jax.sharding import Mesh as JMesh
    n = int(np.prod(shape))
    return JMesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _tgrid(shape, names):
    if len(shape) == 1:
        return Mesh(None, 0, shape[0], torch.device("cpu"))
    return Grid2D(tuple(shape), (0, 0), None, None, tuple(names))


@pytest.mark.parametrize("raw,want", [("", None), ("2x4", (2, 4)),
                                      ("1x8", (1, 8)), (" 4X2 ", (4, 2))])
def test_override_parses_as_jax(monkeypatch, raw, want):
    _both(monkeypatch, raw)
    assert ttopo.fabric_override() == jtopo.fabric_override() == want


@pytest.mark.parametrize("raw", ["2x", "axb", "0x4", "2x4x1", "8"])
def test_malformed_override_raises_as_jax(monkeypatch, raw):
    _both(monkeypatch, raw)
    with pytest.raises(ValueError) as got:
        ttopo.fabric_override()
    with pytest.raises(ValueError) as want:
        jtopo.fabric_override()
    # the same message, in the port's words for the same layout
    assert str(got.value).replace(TENV, JENV).replace(
        "hosts x ranks-per-host", "slices x devices-per-slice") == \
        str(want.value)


LAYOUTS = [("2x4", (2, 4), ("r", "c")), ("2x4", (4, 2), ("r", "c")),
           ("4x2", (2, 4), ("a", "b")), ("2x2", (2, 2), ("r", "c")),
           ("2x4", (8,), ("sp",)), ("", (2, 4), ("r", "c"))]


@pytest.mark.parametrize("raw,shape,names", LAYOUTS)
def test_classification_matches_jax(monkeypatch, raw, shape, names):
    _both(monkeypatch, raw)
    jm, tm = _jmesh(shape, names), _tgrid(shape, names)
    jf = jtopo.mesh_fabrics(jm)
    assert ttopo.mesh_fabrics(tm) == {k: FAB[v] for k, v in jf.items()}
    assert ttopo.is_hybrid(tm) == jtopo.is_hybrid(jm)
    jh, th = jtopo.hybrid_axes(jm), ttopo.hybrid_axes(tm)
    assert (th is None) == (jh is None)
    if jh is not None:
        assert th == jh
        assert ttopo.topology_key(tm) == jtopo.topology_key(jm).replace(
            "dcn", "ib").replace("ici", "nvlink")
    else:
        assert ttopo.topology_key(tm) == jtopo.topology_key(jm) == ""
    for ax in names:
        assert ttopo.slice_run(tm, ax) == jtopo.slice_run(jm, ax)
        jc = jtopo.collective_fabric(jm, ax)
        assert ttopo.collective_fabric(tm, ax) == (
            None if jc is None else FAB[jc])
    assert ttopo.slice_map(tm) == jtopo.slice_map(jm)
    n = int(np.prod(shape))
    ring = [(i, (i + 1) % n) for i in range(n)]
    assert ttopo.perm_crossings(tm, names, ring) == \
        jtopo.perm_crossings(jm, names, ring)


def test_ib_axis_by_name_and_world_of_one(monkeypatch):
    monkeypatch.delenv(TENV, raising=False)
    g = Grid2D((2, 2), (0, 0), None, None, ("ib", "nvlink"))
    assert ttopo.axis_fabric(g, "ib") == "ib"
    assert ttopo.axis_fabric(g, 1) == "nvlink"
    assert ttopo.topology_key(g) == "ib2xnvlink2"
    # no group: one rank on one host, whatever the override
    monkeypatch.setenv(TENV, "2x2")
    assert ttopo.world_key() == "" and ttopo.world_shape() is None
    assert ttopo.group_fabric(None) is None
    assert ttopo.topology_key(None) == ""


def test_byte_counters_by_fabric(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_METRICS", "on")
    metrics.clear_metrics()
    for fab in (None, "nvlink", "ib", "h2d", "d2h"):
        metrics.collective_bytes("x", 8, fab)
    c = metrics.snapshot()["counters"]
    assert c["collective.x.bytes"] == 24
    assert c["collective.x.bytes_nvlink"] == c["collective.x.bytes_ib"] == 8
    assert c["collective.x.bytes_h2d"] == c["collective.x.bytes_d2h"] == 8
    metrics.clear_metrics()


def test_costmodel_fabric_terms_match_jax():
    from pylops_mpi_tpu.diagnostics import costmodel as jcm
    assert tcm.peak_dcn_gbps("NVIDIA H100 80GB HBM3") == 50.0
    assert tcm.peak_dcn_gbps("some other card") is None
    assert tcm.device_peaks("cpu")["dcn_gbps"] is None
    for hier in (False, True):
        got = tcm.pencil_transpose_cost((64, 32, 16), 4, 8, 2, (2, 2), hier)
        want = jcm.pencil_transpose_cost((64, 32, 16), 4, 8, 2, (2, 2), hier)
        assert (got.ici_bytes, got.dcn_bytes, got.hbm_bytes) == \
            (want.ici_bytes, want.dcn_bytes, want.hbm_bytes)
    cost = tcm.OpCost(hbm_bytes=1e9, ici_bytes=1e6, dcn_bytes=5e9)
    peaks = {"hbm_gbps": 3350.0, "ici_gbps": 450.0, "dcn_gbps": 50.0}
    assert tcm.roofline(cost, peaks)["bound"] == "dcn"


# ------------------------------------------------------------- ranks
@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(topology_rank, 4, tmp_path_factory.mktemp("topo4"))


def test_flat_world_adds_no_counter_and_keeps_keys(world4):
    for r, out in enumerate(world4):
        flat = out["flat"]
        assert flat["shape"] == (1, 4) and flat["coords"] == (0, r)
        assert flat["key"] == flat["world_key"] == flat["signature"] == ""
        assert "|t" not in flat["plan_key"]
        assert not [k for k in flat["counters"] if "bytes_" in k]
        assert flat["counters"]["collective.all_reduce.calls"] == 3


def test_hybrid_world_splits_bytes_and_keys(world4):
    for r, out in enumerate(world4):
        hyb = out["hybrid"]
        assert hyb["shape"] == (2, 2) and hyb["coords"] == divmod(r, 2)
        assert hyb["axis_names"] == ("ib", "nvlink")
        assert hyb["fabrics"] == {"ib": "ib", "nvlink": "nvlink"}
        assert hyb["key"] == hyb["world_key"] == hyb["signature"] \
            == "ib2xnvlink2"
        assert hyb["plan_key"].endswith("|tib2xnvlink2")
        assert hyb["plan_key"][:-len("|tib2xnvlink2")] == \
            out["flat"]["plan_key"]
        c = hyb["counters"]
        # the world's and the column's all_reduce cross hosts; the row's
        # (one host's ranks) stays on NVLink
        assert c["collective.all_reduce.bytes_ib"] == 2 * 32
        assert c["collective.all_reduce.bytes_nvlink"] == 32
        assert c["collective.all_reduce.bytes"] == 3 * 32


def test_bad_dcn_size_names_valid_sizes(world4):
    import pylops_mpi_tpu as pmt
    with pytest.raises(ValueError) as want:
        pmt.make_mesh_hybrid(dcn_size=3)
    assert "Valid dcn_size values here: [1, 2, 4, 8]" in str(want.value)
    for out in world4:
        assert out["bad"].startswith("make_mesh_hybrid: dcn_size=3 does "
                                     "not divide the rank count 4")
        assert out["bad"].endswith("Valid dcn_size values here: [1, 2, 4]")
