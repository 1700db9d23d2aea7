"""The port's segmented solves and checkpoints held against the JAX
package: epochs bit for bit the fused loop, a killed solve resumed bit
for bit from either backend, plan and schema refusals, the guarded
status, restores on another world (gloo ranks spawned with
``torch.multiprocessing``), a kill in the middle of a save, block CG,
and a JAX checkpoint resumed in the port (``convert.fused_carry_from_jax``).

Problems are the JAX suite's (``tests/test_resilience.py``): 8 blocks of
6×6 SPD or 7×4 least-squares, f64, the same seeded numpy blocks in both
packages. Tolerances: port against port bitwise (``torch.equal``); port
against JAX 1e-12 relative to the largest entry.
"""

import os
import pickle
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.solvers.segmented import cgls_segmented as jcgls_seg
from pylops_mpi_tpu_torch.resilience import status as tstatus
from pylops_mpi_tpu_torch.solvers.segmented import (
    block_cg_segmented, cg_segmented, cgls_segmented, resolve_epoch)
from pylops_mpi_tpu_torch.utils import checkpoint as ckpt

from test_torch_process_group import close, run_world
from torch_resilience_ranks import Kill, killer, resume_rank, seg_rank

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_KNOBS = ("PYLOPS_MPI_TPU_TORCH_CA", "PYLOPS_MPI_TPU_TORCH_SEGMENT",
          "PYLOPS_MPI_TPU_TORCH_CKPT_BACKEND", "PYLOPS_MPI_TPU_TORCH_GUARDS")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    tstatus.clear_statuses()
    yield
    pmt.clear_fused_cache()


def spd_blocks(seed, nblk=8, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nblk):
        a = rng.standard_normal((n, n))
        out.append(a @ a.T + n * np.eye(n))
    return out, rng


def ls_blocks(seed, nblk=8, m=7, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m, n)) for _ in range(nblk)], rng


def tbd(blocks):
    return pmtt.convert.blockdiag_from_numpy(blocks, device="cpu")


def tvec(v):
    return pmtt.DistributedArray.to_dist(np.asarray(v), device="cpu")


def ls_problem(seed=0):
    blocks, rng = ls_blocks(seed)
    xt = rng.standard_normal(8 * 4)
    y = np.concatenate([b @ xt[4 * i:4 * (i + 1)]
                        for i, b in enumerate(blocks)])
    return blocks, y


# ------------------------------------------------------ epochs vs fused
@pytest.mark.parametrize("solver", ["cg", "cgls"])
def test_single_epoch_equals_fused(solver):
    if solver == "cg":
        blocks, rng = spd_blocks(1)
        y = rng.standard_normal(48)
    else:
        blocks, y = ls_problem(1)
    T, ty = tbd(blocks), tvec(y)
    fused = getattr(pmtt, solver)(T, ty, niter=30, tol=0.0)
    seg_fn = cg_segmented if solver == "cg" else cgls_segmented
    one = seg_fn(T, ty, niter=30, tol=0.0, epoch=30)
    many = seg_fn(T, ty, niter=30, tol=0.0, epoch=7)
    assert one.epochs == 1 and many.epochs == 5
    for seg in (one, many):
        assert torch.equal(seg.x.array, fused[0].array)
        assert seg.iiter == 30 and seg.status == "maxiter"
    # and the JAX package's segmented solve agrees (over the iterations
    # before the recurrence reaches round-off, where the two packages'
    # summation orders part)
    J = pmt.MPIBlockDiag([JM(b) for b in blocks])
    jseg = getattr(pmt, f"{solver}_segmented")(
        J, pmt.DistributedArray.to_dist(y), niter=6, tol=0.0, epoch=4)
    seg = seg_fn(T, ty, niter=6, tol=0.0, epoch=4)
    close(seg.x.asarray(), np.asarray(jseg.x.asarray()))
    close(seg.cost.numpy(), np.asarray(jseg.cost))


@pytest.mark.parametrize("backend", ["native", "shards"])
def test_kill_resume_bitwise(tmp_path, backend):
    blocks, y = ls_problem(2)
    T, ty = tbd(blocks), tvec(y)
    ref = cgls_segmented(T, ty, niter=40, tol=0.0, epoch=5)
    path = str(tmp_path / "carry.ckpt")
    with pytest.raises(Kill):
        cgls_segmented(T, ty, niter=40, tol=0.0, epoch=5,
                       checkpoint_path=path, backend=backend,
                       on_epoch=killer(3))
    assert os.path.isdir(path) == (backend == "shards")
    res = cgls_segmented(T, ty, niter=40, tol=0.0, epoch=5,
                         checkpoint_path=path, backend=backend)
    assert res.iiter == ref.iiter == 40 and res.epochs == 5
    assert torch.equal(res.x.array, ref.x.array)
    assert torch.equal(res.cost, ref.cost)


def test_plan_mismatch_and_ca_stamp_refuse(tmp_path, monkeypatch):
    blocks, y = ls_problem(3)
    T, ty = tbd(blocks), tvec(y)
    path = str(tmp_path / "c.ckpt")
    cgls_segmented(T, ty, niter=20, tol=0.0, epoch=5, checkpoint_path=path)
    with pytest.raises(ValueError, match="resume must replay"):
        cgls_segmented(T, ty, niter=25, tol=0.0, epoch=5,
                       checkpoint_path=path)
    with pytest.raises(ValueError, match="resume must replay"):
        cgls_segmented(T, ty, niter=20, damp=0.5, tol=0.0, epoch=5,
                       checkpoint_path=path)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "pipelined")
    with pytest.raises(ValueError, match="ca='off'"):
        cgls_segmented(T, ty, niter=20, tol=0.0, epoch=5,
                       checkpoint_path=path)
    with pytest.raises(ValueError, match="resume_state"):
        cgls_segmented(T, ty, niter=21, tol=0.0,
                       resume_state={"niter": 20})


@pytest.mark.parametrize("mode", ["pipelined", "sstep"])
def test_ca_segmented_equals_fused_and_resumes(tmp_path, monkeypatch, mode):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", mode)
    blocks, rng = spd_blocks(4)
    T, ty = tbd(blocks), tvec(rng.standard_normal(48))
    fused = pmtt.cg(T, ty, niter=10, tol=0.0)
    ref = cg_segmented(T, ty, niter=10, tol=0.0, epoch=4)
    assert torch.equal(ref.x.array, fused[0].array)
    path = str(tmp_path / "ca.ckpt")
    with pytest.raises(Kill):
        cg_segmented(T, ty, niter=10, tol=0.0, epoch=4, checkpoint_path=path,
                     on_epoch=killer(2))
    assert ckpt.load_pytree(path, device="cpu")["ca"] == mode
    res = cg_segmented(T, ty, niter=10, tol=0.0, epoch=4,
                       checkpoint_path=path)
    assert torch.equal(res.x.array, ref.x.array) and res.iiter == ref.iiter


def test_schema_validation(tmp_path):
    p = str(tmp_path / "f.ckpt")
    ckpt.save_fused_carry(p, "cgls", {"niter": 3, "kold": 1.0})
    with pytest.raises(ValueError, match="is for 'cgls'"):
        ckpt.load_fused_carry(p, "cg", device="cpu")
    assert ckpt.load_fused_carry(p, "cgls", device="cpu")["niter"] == 3
    ckpt.save_pytree(p, {"niter": 3})
    with pytest.raises(ValueError, match="not a fused-carry"):
        ckpt.load_fused_carry(p, "cgls", device="cpu")
    ckpt.save_pytree(p, {"__fused__": "cg", "__fused_schema__": 99})
    with pytest.raises(ValueError, match="schema"):
        ckpt.load_fused_carry(p, "cg", device="cpu")
    with pytest.raises(NotImplementedError, match="shards"):
        ckpt.save_pytree(p, {"k": 1}, backend="orbax")


def test_guarded_status_kept():
    blocks, rng = spd_blocks(5)
    y = rng.standard_normal(48)
    seg = cg_segmented(tbd(blocks), tvec(y), niter=100, tol=1e-12, epoch=9,
                       guards=True)
    jseg = pmt.cg_segmented(pmt.MPIBlockDiag([JM(b) for b in blocks]),
                            pmt.DistributedArray.to_dist(y), niter=100,
                            tol=1e-12, epoch=9, guards=True)
    assert seg.status == jseg.status == "converged"
    assert seg.iiter == jseg.iiter
    assert tstatus.last_status("cg")["status_name"] == "converged"
    close(seg.x.asarray(), np.asarray(jseg.x.asarray()))


def test_resolve_epoch_env(monkeypatch):
    assert resolve_epoch(None, 40) == 40
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_SEGMENT", "8")
    assert resolve_epoch(None, 40) == 8
    assert resolve_epoch(13, 40) == 13
    assert resolve_epoch(999, 40) == 40


def test_save_load_solver_class_api(tmp_path):
    blocks, y = ls_problem(6)
    T, ty = tbd(blocks), tvec(y)
    ref = pmtt.CGLS(T)
    x = ref.setup(ty, tvec(np.zeros(32)), niter=6, tol=0.0)
    for _ in range(3):
        x = ref.step(x)
    path = str(tmp_path / "s.ckpt")
    ckpt.save_solver(path, ref, x)
    for _ in range(3):
        x = ref.step(x)
    other = pmtt.CGLS(T)
    xr = ckpt.load_solver(path, other, device="cpu")
    for _ in range(3):
        xr = other.step(xr)
    assert other.iiter == ref.iiter == 6
    assert torch.equal(xr.array, x.array)


# ------------------------------------------------------ other worlds
@pytest.mark.parametrize("old,new,backend", [(2, 1, "shards"),
                                             (3, 2, "native")])
def test_restore_on_another_world(tmp_path, old, new, backend):
    blocks, y = ls_problem(7)
    path = str(tmp_path / "w.ckpt")
    # 12 iterations: short of round-off, where the worlds' summation
    # orders would part
    ref = cgls_segmented(tbd(blocks), tvec(y), niter=12, tol=0.0, epoch=4)
    assert run_world(seg_rank, old, tmp_path, blocks, y, path, backend,
                     12, 2) == [old] * old
    if new == 1:
        outs = [resume_rank(blocks, y, path, backend, 12)]
    else:
        outs = run_world(resume_rank, new, tmp_path, blocks, y, path,
                         backend, 12)
    for x, iiter, epochs in outs:
        assert iiter == 12 and epochs == 1
        close(x, ref.x.asarray(), rtol=1e-12)


def test_masked_or_short_axis_restore_refuses(tmp_path):
    p = str(tmp_path / "m.ckpt")
    enc = {"x": {"__dist__": True, "value": np.arange(8.0),
                 "partition": "SCATTER", "axis": 0,
                 "local_shapes": ((4,), (4,)), "mask": (0, 1)},
           "__blobfile__": None}
    with open(p, "wb") as f:
        pickle.dump(enc, f)
    with pytest.raises(ValueError, match="masked"):
        ckpt.load_pytree(p, device="cpu")
    enc["x"]["mask"] = None
    with open(p, "wb") as f:
        pickle.dump(enc, f)
    assert ckpt.load_pytree(p, device="cpu")["x"].local_shapes == ((8,),)
    with pytest.raises(ValueError, match="zero rows"):
        ckpt._check_elastic(pmtt.Partition.SCATTER, 0, (2,), None, 1, 3)


def test_kill_mid_save_keeps_previous(tmp_path):
    path = str(tmp_path / "c.ckpt")
    v1 = np.random.default_rng(8).standard_normal(24)
    ckpt.save_pytree(path, {"x": tvec(v1), "k": 1})
    code = f"""
import os, signal, sys
sys.path.insert(0, {ROOT!r})
import numpy as np
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu_torch.utils import checkpoint as ckpt
os.replace = lambda *a, **k: os.kill(os.getpid(), signal.SIGKILL)
x = pmtt.DistributedArray.to_dist(np.arange(24.0), device="cpu")
ckpt.save_pytree({path!r}, {{"x": x, "k": 2}})
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == -signal.SIGKILL, p.stderr[-2000:]
    tmps = [f for f in os.listdir(tmp_path) if f.startswith("c.ckpt.tmp")]
    assert tmps
    for t in tmps:
        with open(tmp_path / t, "r+b") as f:
            f.truncate(max(os.path.getsize(tmp_path / t) // 2, 1))
    got = ckpt.load_pytree(path, device="cpu")
    np.testing.assert_array_equal(got["x"].asarray(), v1)
    assert got["k"] == 1
    ckpt.save_pytree(path, {"x": tvec(np.ones(24)), "k": 3})
    assert not [f for f in os.listdir(tmp_path)
                if f.startswith("c.ckpt.tmp")]
    assert ckpt.load_pytree(path, device="cpu")["k"] == 3


# ------------------------------------------------------ block CG
def test_block_cg_segmented_matches_jax(tmp_path):
    blocks, rng = spd_blocks(9)
    Y = rng.standard_normal((48, 3))
    T = tbd(blocks)
    tY = pmtt.DistributedArray.to_dist(Y, device="cpu")
    x, iiter, cost, codes = block_cg_segmented(T, tY, niter=30, tol=1e-20,
                                               epoch=7)
    fused = pmtt.block_cg(T, tY, niter=30, tol=1e-20)
    assert torch.equal(x.array, fused[0].array) and iiter == fused[1]
    jY = pmt.DistributedArray(global_shape=Y.shape)
    jY[:] = Y
    jx, jit, jcost, jcodes = pmt.block_cg_segmented(
        pmt.MPIBlockDiag([JM(b) for b in blocks]), jY, niter=30, tol=1e-20,
        epoch=7)
    assert iiter == int(jit) and codes == [int(c) for c in jcodes]
    close(x.asarray(), np.asarray(jx.asarray()))
    path = str(tmp_path / "b.ckpt")
    with pytest.raises(Kill):
        block_cg_segmented(T, tY, niter=30, tol=1e-20, epoch=7,
                           checkpoint_path=path, on_epoch=killer(2))
    xr, itr, _, _ = block_cg_segmented(T, tY, niter=30, tol=1e-20, epoch=7,
                                       checkpoint_path=path)
    assert torch.equal(xr.array, x.array) and itr == iiter


# ------------------------------------------------------ JAX → port
def test_jax_checkpoint_resumes_in_port(tmp_path):
    blocks, y = ls_problem(10)
    J = pmt.MPIBlockDiag([JM(b) for b in blocks])
    jy = pmt.DistributedArray.to_dist(y)
    jref = jcgls_seg(J, jy, niter=40, tol=0.0, epoch=5)
    path = str(tmp_path / "jax.ckpt")
    with pytest.raises(Kill):
        jcgls_seg(J, jy, niter=40, tol=0.0, epoch=5, checkpoint_path=path,
                  on_epoch=killer(3))
    carry = pmtt.convert.fused_carry_from_jax(path, "cgls", device="cpu")
    assert int(carry["iiter"]) == 15
    res = cgls_segmented(tbd(blocks), tvec(y), niter=40, tol=0.0, epoch=5,
                         resume_state=carry)
    assert res.iiter == 40 and res.epochs == 5
    close(res.x.asarray(), np.asarray(jref.x.asarray()), rtol=1e-12)
    # a file that holds anything but numpy and builtins is refused
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        pickle.dump({"__fused__": "cgls", "x": pmt.Partition.SCATTER}, f)
    with pytest.raises(pickle.UnpicklingError, match="Partition"):
        pmtt.convert.fused_carry_from_jax(bad, device="cpu")
