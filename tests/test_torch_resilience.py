"""The port's resilience tier held against the JAX package: fault
injection into every guarded loop, ``resilient_solve``'s precision
ladder, ``refined_solve``, the refine knob, bounded retry, plan-cache
corruption, and the fault spec in a captured loop's key.

The same seeded numpy blocks go through both packages; the same fault
is armed in each (``faults.arm`` of each package), so the NaN lands at
the same iteration's apply. Problems are the JAX suite's
(``tests/test_resilience.py``): 8 blocks of 6×6 SPD or 7×4
least-squares. Tolerances: f64 x within 1e-10 relative to its largest
entry, statuses and iteration counts equal; the bf16 → f32 ladder's
x within 2e-3 of the f64 oracle (the JAX test's bar); ``refined_solve``
x within 1e-9 and pass counts within ±1.
"""

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu import resilience as jres
from pylops_mpi_tpu.ops import _precision as jprec
from pylops_mpi_tpu.ops.local import MatrixMult as JM
from pylops_mpi_tpu.resilience import faults as jfaults
from pylops_mpi_tpu.solvers.basic import cg_guarded as jcg_guarded
from pylops_mpi_tpu.solvers.basic import cgls_guarded as jcgls_guarded
from pylops_mpi_tpu.solvers.sparsity import fista_guarded as jfista_g
from pylops_mpi_tpu.solvers.sparsity import ista_guarded as jista_g
from pylops_mpi_tpu_torch import resilience as tres
from pylops_mpi_tpu_torch.ops import _precision as tprec
from pylops_mpi_tpu_torch.resilience import faults as tfaults
from pylops_mpi_tpu_torch.resilience import status as tstatus

from test_torch_process_group import close

_KNOBS = ("PYLOPS_MPI_TPU_GUARDS", "PYLOPS_MPI_TPU_GUARD_STALL",
          "PYLOPS_MPI_TPU_CA", "PYLOPS_MPI_TPU_REFINE",
          "PYLOPS_MPI_TPU_TORCH_GUARDS", "PYLOPS_MPI_TPU_TORCH_GUARD_STALL",
          "PYLOPS_MPI_TPU_TORCH_CA", "PYLOPS_MPI_TPU_TORCH_REFINE",
          "PYLOPS_MPI_TPU_TORCH_RESTARTS", "PYLOPS_MPI_TPU_TORCH_AOT")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    jfaults.disarm()
    tfaults.disarm()
    tstatus.clear_statuses()
    yield
    jfaults.disarm()
    tfaults.disarm()
    pmt.clear_fused_cache()


def spd_blocks(seed, nblk=8, n=6, dtype=np.float64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(nblk):
        a = rng.standard_normal((n, n))
        out.append((a @ a.T + n * np.eye(n)).astype(dtype))
    return out, rng


def ls_blocks(seed, nblk=8, m=7, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m, n)) for _ in range(nblk)], rng


def pair(blocks):
    return (pmt.MPIBlockDiag([JM(b) for b in blocks]),
            pmtt.convert.blockdiag_from_numpy(blocks, device="cpu"))


def vecs(v):
    return (pmt.DistributedArray.to_dist(np.asarray(v)),
            pmtt.DistributedArray.to_dist(np.asarray(v), device="cpu"))


def arm(kind, at):
    jfaults.arm(kind, at)
    tfaults.arm(kind, at)


def problem(kind, seed):
    if kind == "cg":
        blocks, rng = spd_blocks(seed)
        y = rng.standard_normal(48)
    else:
        blocks, rng = ls_blocks(seed)
        y = rng.standard_normal(56)
    return pair(blocks) + vecs(y)


def guarded(kind, J, T, jy, ty, niter, tol=1e-30):
    """``(x, iiter, code)`` of the guarded solve in each package."""
    if kind == "cg":
        jo = jcg_guarded(J, jy, niter=niter, tol=tol)
        to = pmtt.cg_guarded(T, ty, niter=niter, tol=tol)
        return (jo[0], jo[1], jo[3]), (to[0], to[1], to[3])
    normal = kind == "cgls_normal"
    jo = jcgls_guarded(J, jy, niter=niter, tol=tol, normal=normal)
    to = pmtt.cgls_guarded(T, ty, niter=niter, tol=tol, normal=normal)
    return (jo[0], jo[1], jo[5]), (to[0], to[1], to[5])


def same(jo, to, rtol=1e-10):
    assert int(to[1]) == int(jo[1]) and int(to[2]) == int(jo[2])
    assert np.all(np.isfinite(to[0].asarray()))
    close(to[0].asarray(), np.asarray(jo[0].asarray()), rtol=rtol)


# ------------------------------------------------------ injection
@pytest.mark.parametrize("kind", ["cg", "cgls", "cgls_normal"])
def test_nan_injection_breakdown(kind):
    J, T, jy, ty = problem(kind, 1)
    arm("nan", 4)
    jo, to = guarded(kind, J, T, jy, ty, 200)
    assert to[2] == tstatus.BREAKDOWN and to[1] <= 6
    assert tfaults.armed() is None  # one-shot, consumed
    same(jo, to)


@pytest.mark.parametrize("kind", ["cg", "cgls"])
def test_stall_injection_stagnation(kind, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_GUARD_STALL", "5")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", "5")
    J, T, jy, ty = problem(kind, 2)
    arm("stall", 3)
    jo, to = guarded(kind, J, T, jy, ty, 200)
    assert to[2] == tstatus.STAGNATION and to[1] < 200
    same(jo, to)


@pytest.mark.parametrize("name,fault", [("ista", "nan"), ("fista", "nan"),
                                        ("ista", "stall")])
def test_sparse_injection(name, fault, monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_GUARD_STALL", "4")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_GUARD_STALL", "4")
    J, T, jy, ty = problem("cg", 3)
    jx0, tx0 = vecs(np.zeros(48))
    arm(fault, 3)
    jfn = jista_g if name == "ista" else jfista_g
    tfn = getattr(pmtt.solvers, f"{name}_guarded")
    kw = dict(niter=50, eps=0.01, alpha=0.02, tol=0.0)
    jo = jfn(J, jy, jx0, **kw)
    to = tfn(T, ty, tx0, **kw)
    want = tstatus.BREAKDOWN if fault == "nan" else tstatus.STAGNATION
    assert to[3] == want and to[1] < 50
    assert tstatus.last_status(name)["status"] == want
    same((jo[0], jo[1], jo[3]), (to[0], to[1], to[3]))


@pytest.mark.parametrize("kind", ["cg", "cgls_normal", "sstep"])
def test_ca_engine_injection(kind, monkeypatch):
    mode = "sstep" if kind == "sstep" else "pipelined"
    monkeypatch.setenv("PYLOPS_MPI_TPU_CA", mode)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", mode)
    solver = "cg" if kind == "sstep" else kind
    J, T, jy, ty = problem(solver, 4)
    arm("nan", 3)  # an armed fault sends s-step to the pipelined engine
    jo, to = guarded(solver, J, T, jy, ty, 100)
    assert to[2] == tstatus.BREAKDOWN
    same(jo, to)


def test_fault_arm_validation():
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.arm("gamma-ray", 3)
    with pytest.raises(ValueError, match="iteration"):
        tfaults.arm("nan", -1)
    tfaults.arm("nan", 2, once=False)
    assert tfaults.consume() == {"kind": "nan", "iteration": 2,
                                 "once": False}
    assert tfaults.armed() is not None
    assert tfaults.fault_signature() == ("faults", "nan", 2)
    tfaults.disarm()
    assert tfaults.fault_signature() == jfaults.fault_signature()


def test_fault_spec_changes_graph_key(monkeypatch):
    from pylops_mpi_tpu_torch.aot import graphs
    keys = []

    class Spy(graphs.Loop):
        def __init__(self, solver, scalars, Op, M, y, state, consts, step,
                     **kw):
            keys.append(graphs.key(solver, scalars, Op, M, y,
                                   graphs._flat(state)
                                   + graphs._flat(consts)))
            super().__init__(solver, scalars, Op, M, y, state, consts, step,
                             **kw)

    monkeypatch.setattr(graphs, "Loop", Spy)
    _, T, _, ty = problem("cg", 5)
    pmtt.cg_guarded(T, ty, niter=10)
    tfaults.arm("nan", 4)
    pmtt.cg_guarded(T, ty, niter=10)
    pmtt.cg_guarded(T, ty, niter=10)  # the fault was consumed: clean
    tfaults.arm("stall", 4)
    pmtt.cg(T, ty, niter=10, guards=False)  # unguarded: never injects
    clean, poisoned, again, plain = keys
    assert clean != poisoned and again == clean
    assert ("fault", ("faults", "nan", 4)) in poisoned[1]
    assert not any(k == "fault" for k, _ in plain[1])
    assert tfaults.armed() is not None  # an unguarded solve left it


# ------------------------------------------------------ resilient_solve
def test_escalate_dtype_ladder():
    import jax.numpy as jnp
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16), (np.float16, None),
                    (np.float32, None), (np.float64, None),
                    (np.complex64, None), (np.complex128, None)):
        want = jprec.escalate_dtype(dt)
        got = tprec.escalate_dtype(tdt or dt)
        assert (None if got is None else tprec.dtype_name(got)) == \
            (None if want is None else want.name)


def test_f64_fault_attempt_and_bounded_restarts():
    J, T, jy, ty = problem("cg", 6)
    arm("nan", 5)
    jr = jres.resilient_solve(lambda cdt: J, jy, solver="cg", niter=100,
                              tol=1e-12, max_restarts=0)
    tr = tres.resilient_solve(lambda cdt: T, ty, solver="cg", niter=100,
                              tol=1e-12, max_restarts=0)
    assert tr.status == jr.status == "breakdown" and tr.restarts == 0
    assert tr.attempts == jr.attempts
    close(tr.x.asarray(), np.asarray(jr.x.asarray()), rtol=1e-10)


def test_plain_operator_no_escalation():
    J, T, jy, ty = problem("cg", 7)
    tr = tres.resilient_solve(T, ty, solver="cg", niter=200, tol=1e-12)
    jr = jres.resilient_solve(J, jy, solver="cg", niter=200, tol=1e-12)
    assert tr.status == jr.status == "converged" and tr.restarts == 0
    assert tr.attempts == jr.attempts
    close(tr.x.asarray(), np.asarray(jr.x.asarray()), rtol=1e-10)
    tfaults.arm("nan", 2)
    tr = tres.resilient_solve(T, ty, solver="cg", niter=200, tol=1e-12)
    assert tr.status == "breakdown" and len(tr.attempts) == 1
    with pytest.raises(ValueError, match="solver="):
        tres.resilient_solve(T, ty, solver="gmres")


@pytest.mark.parametrize("normal", [False, True])
def test_bf16_escalation_ladder(normal):
    blocks, rng = spd_blocks(8, dtype=np.float32)
    dense = np.zeros((48, 48))
    for i, m in enumerate(blocks):
        dense[6 * i:6 * (i + 1), 6 * i:6 * (i + 1)] = m
    y32 = (dense @ rng.standard_normal(48)).astype(np.float32)
    oracle = np.linalg.solve(dense, y32.astype(np.float64))
    jy, ty = vecs(y32)

    def jmake(cdt):
        return pmt.MPIBlockDiag([JM(m, dtype=np.float32) for m in blocks],
                                compute_dtype=cdt)

    def tmake(cdt):
        return pmtt.convert.blockdiag_from_numpy(blocks, compute_dtype=cdt,
                                                 device="cpu")

    jprec.set_precision("bf16")
    tprec.set_precision("bf16")
    try:
        arm("nan", 4)
        jr = jres.resilient_solve(jmake, jy, solver="cgls", niter=400,
                                  tol=1e-12, normal=normal)
        tr = tres.resilient_solve(tmake, ty, solver="cgls", niter=400,
                                  tol=1e-12, normal=normal)
    finally:
        jprec.set_precision(None)
        tprec.set_precision(None)
    ladder = [(a["compute_dtype"], a["status"]) for a in tr.attempts]
    assert ladder == [(a["compute_dtype"], a["status"])
                      for a in jr.attempts]
    assert ladder[0] == ("bfloat16", "breakdown") and tr.restarts == 1
    assert ladder[1][0] == "float32"
    assert tr.attempts[0]["iiter"] == jr.attempts[0]["iiter"] <= 6
    for res in (tr, jr):
        x = np.asarray(res.x.asarray(), np.float64)
        assert np.linalg.norm(x - oracle) / np.linalg.norm(oracle) < 2e-3


# ------------------------------------------------------ refinement
def _refine_pair(kind, seed):
    if kind == "cg":
        blocks, rng = spd_blocks(seed)
        y = rng.standard_normal(48)
    else:
        # consistent data (the JAX refinement tests' y = A x)
        blocks, rng = ls_blocks(seed)
        xt = rng.standard_normal(32)
        y = np.concatenate([b @ xt[4 * i:4 * (i + 1)]
                            for i, b in enumerate(blocks)])

    def jmake(dt):
        dt = np.dtype(dt or np.float64)
        return pmt.MPIBlockDiag([JM(b.astype(dt), dtype=dt) for b in blocks])

    def tmake(dt):
        return pmtt.convert.blockdiag_from_numpy(
            blocks, dtype=dt or torch.float64, device="cpu")

    return jmake, tmake, vecs(y)


@pytest.mark.parametrize("kind,damp", [("cg", 0.0), ("cgls", 0.0),
                                       ("cgls", 0.7)])
def test_refined_solve_f32_inner(kind, damp):
    jmake, tmake, (jy, ty) = _refine_pair(kind, 9)
    kw = dict(solver=kind, niter=200, tol=1e-11, damp=damp,
              inner_niter=80, inner_tol=1e-4, max_passes=10)
    import jax.numpy as jnp
    jr = jres.refined_solve(jmake, jy, inner_dtype=jnp.float32, **kw)
    tr = tres.refined_solve(tmake, ty, inner_dtype=torch.float32, **kw)
    assert tr.status == jr.status == "converged"
    assert abs(tr.passes - jr.passes) <= 1
    assert all(a["compute_dtype"] == "float32" for a in tr.attempts)
    assert tr.narrow_frac > 0.5
    close(tr.x.asarray(), np.asarray(jr.x.asarray()), rtol=1e-9)


def test_refine_knob_routes_resilient_solve(monkeypatch):
    from pylops_mpi_tpu_torch.utils.deps import refine_enabled
    assert not refine_enabled()
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_REFINE", "1")
    assert refine_enabled()
    _, tmake, (_, ty) = _refine_pair("cg", 10)
    res = tres.resilient_solve(tmake, ty, solver="cg", niter=400,
                               tol=1e-11, inner_niter=80, inner_tol=1e-4)
    assert isinstance(res, tres.ResilientResult)
    assert res.status == "converged"
    direct = tres.refined_solve(tmake, ty, solver="cg", niter=400,
                                tol=1e-11, inner_niter=80, inner_tol=1e-4)
    assert torch.equal(res.x.array, direct.x.array)


# ------------------------------------------------------ host-side chaos
def test_retry_through_flaky():
    from pylops_mpi_tpu_torch.resilience import retry
    slept = []
    fn = tfaults.flaky(lambda v: v * 2, failures=2)
    assert retry.retry_call(fn, 21, retries=3, backoff_s=1.0,
                            sleep=slept.append) == 42
    assert fn.calls == 3 and slept == [1.0, 2.0]
    fn = tfaults.flaky(lambda: "ok", failures=5)
    with pytest.raises(TimeoutError, match="injected"):
        retry.retry_call(fn, retries=2, backoff_s=0.0)
    assert fn.calls == 3


@pytest.mark.parametrize("mode", ["truncate", "garbage", "schema"])
def test_plan_cache_corruption_degrades_to_miss(tmp_path, mode):
    import warnings
    from pylops_mpi_tpu_torch.tuning import cache
    path = str(tmp_path / "plans.json")
    cache.clear_memory()
    cache.store("k1", {"params": {"schedule": "ring"},
                       "provenance": "tuned"}, path=path)
    assert cache.load_plans(path)["k1"]["provenance"] == "tuned"
    tfaults.corrupt_plan_cache(path, mode=mode)
    cache.clear_memory()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert cache.load_plans(path) == {}
        assert cache.lookup("k1", path=path) is None
        cache.store("k2", {"params": {}}, path=path)
        assert cache.load_plans(path)["k2"] == {"params": {}}
    cache.clear_memory()
    with pytest.raises(ValueError, match="corruption mode"):
        tfaults.corrupt_plan_cache(path, mode="melt")
