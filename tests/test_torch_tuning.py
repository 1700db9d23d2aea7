"""The port's tuner (``pylops_mpi_tpu_torch.tuning``) held against the
JAX package's ``pylops_mpi_tpu.tuning`` on the CPU.

- Spaces: ``candidates``, ``default_params`` and ``rank`` equal for every
  registered space over CPU contexts (exact).
- Search: ``measure_candidates`` picks the same winner from the same
  stubbed timings, the 2% hysteresis included (exact).
- ``get_plan``: off, replay, stale params, measurement under ``auto``,
  the reentrancy guard (per thread) and explicit kwargs beating a plan;
  the seed's params equal the JAX package's.
- The plan-key fault: an operator on the CPU keys ``cpu:cpu`` even where
  a card exists (faked here).
- The seams: a banked ``two_sweep`` plan sends ``MPIBlockDiag`` through
  two sweeps, equal to the JAX package's two-sweep result within 1e-12
  (f64, data from seed 11); ``auto_sparse_matmult`` picks the JAX tier at
  95% and 5% sparsity; ``CA=auto`` resolves as the JAX package's, with
  and without the reduction stall, and the stall is bitwise inert.
- The CLI ends in its JSON line.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import pylops_mpi_tpu as pmt
import pylops_mpi_tpu_torch as pmtt
from pylops_mpi_tpu import tuning as jtune
from pylops_mpi_tpu.ops.local import MatrixMult as JMatrixMult
from pylops_mpi_tpu.parallel.mesh import make_mesh
from pylops_mpi_tpu.solvers import ca as jca
from pylops_mpi_tpu.tuning import cache as jcache
from pylops_mpi_tpu.tuning import search as jsearch
from pylops_mpi_tpu.tuning import space as jspace
from pylops_mpi_tpu_torch import tuning as ttune
from pylops_mpi_tpu_torch.diagnostics import trace as ttrace
from pylops_mpi_tpu_torch.ops import normal_kernels as nk
from pylops_mpi_tpu_torch.ops.local import MatrixMult as TMatrixMult
from pylops_mpi_tpu_torch.parallel import collectives as tco
from pylops_mpi_tpu_torch.solvers import ca as tca
from pylops_mpi_tpu_torch.tuning import cache as tcache
from pylops_mpi_tpu_torch.tuning import search as tsearch
from pylops_mpi_tpu_torch.tuning import space as tspace

ROOT = Path(__file__).resolve().parents[1]
_KNOBS = [f"PYLOPS_MPI_TPU{p}_{k}" for p in ("", "_TORCH")
          for k in ("TUNE", "TUNE_CACHE", "TUNE_MARGIN", "TUNE_TOPK",
                    "TUNE_BUDGET", "CA", "REDUCE_STALL", "TRACE", "BATCH")]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    tcache.clear_memory()
    jcache.clear_memory()
    ttune.reset_applied()
    ttrace.clear_events()
    yield
    tcache.clear_memory()
    jcache.clear_memory()
    ttrace.clear_events()


def _contexts():
    """CPU contexts that exercise every seed branch."""
    base = {"axes": ("sp",), "platform": "cpu", "chip": "cpu"}
    out = []
    for n_dev in (1, 4, 8):
        out += [
            dict(base, op="matrixmult", shape=(4096, 2048, 64),
                 dtype=np.float32, n_dev=n_dev,
                 extra={"grid": (2, n_dev // 2) if n_dev > 1 else (1, 1)}),
            dict(base, op="matrixmult", shape=(64, 4096, 8),
                 dtype=np.float32, n_dev=n_dev,
                 extra={"grid": (1, n_dev), "batch": 4}),
            dict(base, op="fft", shape=(512, 256), dtype=np.complex128,
                 n_dev=n_dev, extra={}),
            dict(base, op="blockdiag", shape=(8192, 8192), dtype=np.float32,
                 n_dev=n_dev, extra={"fused_available": True,
                                     "a_bytes": 8 * 1024 * 1024 * 4.0}),
            dict(base, op="blockdiag", shape=(8192, 8192), dtype=np.float32,
                 n_dev=n_dev, extra={"fused_available": False,
                                     "a_bytes": 1e6, "batch": 8}),
            dict(base, op="stack", shape=(8192, 1024), dtype=np.float32,
                 n_dev=n_dev, extra={"batch": 2}),
            dict(base, op="derivative", shape=(4096, 512),
                 dtype=np.float64, n_dev=n_dev, extra={}),
            dict(base, op="halo", shape=(4096, 512), dtype=np.float64,
                 n_dev=n_dev, extra={}),
            dict(base, op="sparse_matmult", shape=(4096, 4096),
                 dtype=np.float32, n_dev=n_dev,
                 extra={"nnz": 100000, "itemsize": 4}),
            dict(base, op="ca", shape=(4096,), dtype=np.float32,
                 n_dev=n_dev, extra={"a_bytes": 6.7e7, "solver": "cgls"}),
        ]
    return out


def test_spaces_equal_jax():
    assert list(tspace.SPACES) == list(jspace.SPACES)
    for name, jsp in jspace.SPACES.items():
        tsp = tspace.SPACES[name]
        assert [(a.name, a.candidates, a.fixed) for a in tsp.axes] == \
            [(a.name, a.candidates, a.fixed) for a in jsp.axes]
    ctxs = _contexts()
    for name in jspace.SPACES:
        for ctx in [c for c in ctxs if c["op"] == name] + \
                [dict(ctxs[0], op=name)]:
            jsp, tsp = jspace.SPACES[name], tspace.SPACES[name]
            assert tspace.candidates(tsp, ctx) == \
                jspace.candidates(jsp, ctx), (name, ctx)
            assert tspace.default_params(tsp, ctx) == \
                jspace.default_params(jsp, ctx), (name, ctx)
            assert tspace.rank(tsp, ctx) == jspace.rank(jsp, ctx), \
                (name, ctx)


def test_card_seed_keeps_overlap_off(monkeypatch):
    # on the card the default resolves overlap=auto as the constructors
    # do: off in a world of one, and off across ranks unless the live
    # group is NCCL (the CPU has none); the seed's pick is the default
    # (the JAX TPU default is on)
    for ctx in _contexts():
        cctx = dict(ctx, platform="cuda", chip="NVIDIA H100 80GB HBM3")
        sp = tspace.SPACES[ctx["op"]]
        dflt = tspace.default_params(sp, cctx)
        assert dflt.get("overlap", "off") == "off"
        top = tspace.rank(sp, cctx)[0]
        assert top.get("overlap", "off") == "off", (ctx["op"], top)
    # under an NCCL group of several ranks the default carries overlap
    # on, and the seed (which prices no hidden transfer) still ranks the
    # default's overlap and chunk count first
    from pylops_mpi_tpu_torch.utils import deps
    monkeypatch.setattr(deps, "overlap_auto", lambda device=None: True)
    for ctx in _contexts():
        cctx = dict(ctx, platform="cuda", chip="NVIDIA H100 80GB HBM3")
        sp = tspace.SPACES[ctx["op"]]
        dflt = tspace.default_params(sp, cctx)
        if "overlap" not in dflt:
            continue
        multi = ctx["n_dev"] > 1 and not (ctx["op"] == "matrixmult"
                                          and ctx["extra"]["grid"] == (1, 1))
        assert dflt["overlap"] == ("on" if multi else "off"), (ctx, dflt)
        assert dflt in tspace.candidates(sp, cctx)
        top = tspace.rank(sp, cctx)[0]
        for k in ("overlap", "comm_chunks"):
            assert top.get(k) == dflt.get(k), (ctx["op"], top, dflt)
    # the blockdiag seed orders the kernel first on the card
    ctx = dict(_contexts()[3], platform="cuda", chip="NVIDIA H100 80GB HBM3")
    assert tspace.rank(tspace.SPACES["blockdiag"], ctx)[0] == \
        {"normal_path": "fused"}


def test_card_lists_only_live_candidates():
    # on the card a candidate differs from the default only in what the
    # port runs: in a world of one no overlap="on" alias (the rings and
    # chunked transposes run the bulk schedules there) and one SUMMA
    # schedule on one tile; across ranks the overlap candidates (and the
    # FFT's chunk ladder) change what runs, and are listed
    card = {"platform": "cuda", "chip": "NVIDIA H100 80GB HBM3"}
    got = {}
    for ctx in _contexts():
        cctx = dict(ctx, **card)
        sp = tspace.SPACES[ctx["op"]]
        cands = tspace.candidates(sp, cctx)
        assert tspace.default_params(sp, cctx) in cands, ctx
        on = [p for p in cands if p.get("overlap") == "on"]
        if ctx["n_dev"] == 1:
            assert not on
        elif "overlap" in cands[0]:
            assert on, ctx
        got.setdefault(ctx["op"], set()).add(len(cands))
    assert got == {"matrixmult": {1, 4}, "fft": {1, 4}, "blockdiag": {1, 2},
                   "stack": {1, 2}, "derivative": {1, 2}, "halo": {1, 2},
                   "sparse_matmult": {2}, "ca": {5}}
    one_tile = dict(_contexts()[0], **card)
    assert one_tile["extra"]["grid"] == (1, 1)
    assert tspace.candidates(tspace.SPACES["matrixmult"], one_tile) == \
        [tspace.default_params(tspace.SPACES["matrixmult"], one_tile)]


def _stub_timer(monkeypatch, times):
    """Both packages' ``time_callable`` return ``times[params]``."""
    def make(mod):
        def fake(fn, repeats=3, warmup=1):
            key = fn()
            t = times[key]
            return {"best_s": t, "mean_s": t, "times_s": [t] * repeats,
                    "compile_s": 0.0}
        return fake
    import importlib
    jb = importlib.import_module("pylops_mpi_tpu.utils.benchmark")
    tb = importlib.import_module("pylops_mpi_tpu_torch.utils.benchmark")
    monkeypatch.setattr(jb, "time_callable", make(jb))
    monkeypatch.setattr(tb, "time_callable", make(tb))


@pytest.mark.parametrize("case", ["winner", "hysteresis", "default_wins"])
def test_search_equals_jax(monkeypatch, case):
    ctx = _contexts()[0]
    jsp, tsp = jspace.SPACES["matrixmult"], tspace.SPACES["matrixmult"]
    cands = jspace.candidates(jsp, ctx)
    keys = [tuple(sorted(p.items())) for p in cands]
    base = {"winner": [1.0, 0.9, 0.5, 0.95],
            "hysteresis": [1.0, 0.99, 0.985, 0.995],
            "default_wins": [0.5, 0.9, 0.7, 0.8]}[case]
    _stub_timer(monkeypatch, dict(zip(keys, base)))

    def factory(params):
        return lambda: tuple(sorted(params.items()))

    jw, jtr = jsearch.measure_candidates(jsp, ctx, factory, budget_s=60)
    tw, ttr = tsearch.measure_candidates(tsp, ctx, factory, budget_s=60)
    assert tw == jw
    assert [(t["params"], t["best_s"], t["ok"]) for t in ttr] == \
        [(t["params"], t["best_s"], t["ok"]) for t in jtr]
    dflt = jspace.default_params(jsp, ctx)
    if case != "winner":
        assert tw == dflt


def _broken_kernel(params):
    if params["normal_path"] == "fused":
        raise RuntimeError("kernel did not build")
    return lambda: torch.zeros(1)


def test_search_records_a_failing_trial(monkeypatch, tmp_path):
    # a kernel that fails is no reason to pick the plain path: the search
    # raises, and get_plan under auto banks nothing
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    ctx = _contexts()[3]
    sp = tspace.SPACES["blockdiag"]
    with pytest.raises(tsearch.TrialError, match="kernel did not build"):
        tsearch.measure_candidates(sp, ctx, _broken_kernel, budget_s=60)
    ev = {tuple(e["args"]["params"].items()): e["args"]
          for e in ttrace.get_events() if e["name"] == "tuning.trial"}
    bad = ev[(("normal_path", "fused"),)]
    assert not bad["ok"] and "kernel did not build" in bad["error"]
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "auto")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE_CACHE",
                       str(tmp_path / "tc.json"))
    kw = dict(shape=(64, 64), dtype=torch.float64, n_dev=1, device="cpu",
              extra={"fused_available": True, "a_bytes": 32768.0})
    with pytest.raises(tsearch.TrialError):
        ttune.get_plan("blockdiag", factory=_broken_kernel, **kw)
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    key = tplan.plan_key("blockdiag", kw["shape"], kw["dtype"], 1, None,
                         kw["extra"], "cpu")
    assert tcache.lookup(key) is None
    assert not (tmp_path / "tc.json").exists() or key not in json.loads(
        (tmp_path / "tc.json").read_text()).get("plans", {})


def test_cli_fails_on_a_failing_trial(monkeypatch, tmp_path):
    from pylops_mpi_tpu_torch.tuning import __main__ as cli
    monkeypatch.setattr(cli, "_blockdiag_case",
                        lambda *a: _broken_kernel)
    out = tmp_path / "plans.json"
    assert cli.main(["--quick", "--device", "cpu", "--family",
                     "blockdiag", "--out", str(out)]) == 1
    assert not out.exists() or not json.loads(out.read_text())["plans"]


def test_search_warms_every_candidate_then_alternates(monkeypatch):
    # order must not decide a race: every candidate is warmed before any
    # is timed, and the timed rounds alternate their order
    ctx = _contexts()[0]
    sp = tspace.SPACES["matrixmult"]
    calls = []

    def fake(fn, repeats=3, warmup=1):
        calls.append((fn(), repeats))
        return {"best_s": 1.0, "mean_s": 1.0, "times_s": [1.0] * repeats,
                "compile_s": 0.0}

    import importlib
    tb = importlib.import_module("pylops_mpi_tpu_torch.utils.benchmark")
    monkeypatch.setattr(tb, "time_callable", fake)
    win, trials = tsearch.measure_candidates(
        sp, ctx, lambda p: (lambda: p["schedule"] + p["overlap"]),
        budget_s=60, repeats=2)
    order = [p["schedule"] + p["overlap"] for p in
             (t["params"] for t in trials)]
    assert calls == [(o, 1) for o in order] + [(o, 2) for o in order] + \
        [(o, 2) for o in order[::-1]]
    assert tsearch.ROUNDS == 2 and all(t["rounds"] == 2 for t in trials)
    assert win == tspace.default_params(sp, ctx)


def test_get_plan_resolution_order(monkeypatch, tmp_path):
    shape, dt = (8192, 8192), torch.float32
    extra = {"fused_available": True, "a_bytes": 2.7e8}
    kw = dict(shape=shape, dtype=dt, n_dev=1, extra=extra, device="cpu")
    # 1. off: None
    assert ttune.get_plan("blockdiag", **kw) is None
    assert ttune.applied_provenance("blockdiag") == "default"
    # 4. on, no cache: the seed, equal to the JAX package's
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TUNE", "on")
    p = ttune.get_plan("blockdiag", **kw)
    jp = jtune.get_plan("blockdiag", shape=shape, dtype=np.float32,
                        n_dev=1, extra=extra)
    assert (p.provenance, p.params) == (jp.provenance, jp.params) == \
        ("costmodel", {"normal_path": "fused"})
    assert p.key == "blockdiag|s8192x8192|float32|mesh[]x1|cpu:cpu"
    # 2. a banked plan replays, without a trial
    path = str(tmp_path / "plans.json")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE_CACHE", path)
    tcache.store(p.key, {"params": {"normal_path": "two_sweep"}})
    tcache.clear_memory()
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    p2 = ttune.get_plan("blockdiag", **kw)
    assert (p2.provenance, p2.params) == ("tuned",
                                          {"normal_path": "two_sweep"})
    assert ttune.applied_provenance("blockdiag") == "tuned"
    assert not [e for e in ttrace.get_events()
                if e["name"] == "tuning.trial"]
    # a stale value is a logged miss, never applied
    tcache.store(p.key, {"params": {"normal_path": "pallas"}})
    p3 = ttune.get_plan("blockdiag", **kw)
    assert p3.provenance == "costmodel"
    assert [e for e in ttrace.get_events()
            if e["name"] == "tuning.cache_error"]
    # no space: None
    assert ttune.get_plan("nonesuch", **kw) is None


def test_get_plan_auto_measures_banks_and_replays(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "auto")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    nested = []

    def factory(params):
        # a candidate under construction never consults the tuner
        nested.append(ttune.get_plan("stack", shape=(8, 4),
                                     device="cpu"))
        t = 1.0 if params["normal_path"] == "fused" else 0.5
        return lambda: t

    _stub_timer(monkeypatch, {1.0: 1e-3, 0.5: 5e-4})
    kw = dict(shape=(64, 64), dtype=torch.float64, n_dev=1, device="cpu",
              extra={"fused_available": True, "a_bytes": 32768.0})
    p = ttune.get_plan("blockdiag", factory=factory, **kw)
    assert p.provenance == "tuned" and p.params == \
        {"normal_path": "two_sweep"} and len(p.trials) == 2
    # each candidate is built for its warm-up and each timed round
    assert nested == [None] * (2 * (1 + tsearch.ROUNDS))
    trials = [e for e in ttrace.get_events() if e["name"] == "tuning.trial"]
    assert len(trials) == 2
    ttrace.clear_events()
    again = ttune.get_plan("blockdiag", factory=factory, **kw)
    assert again.provenance == "tuned" and \
        len(nested) == 2 * (1 + tsearch.ROUNDS)
    assert not [e for e in ttrace.get_events()
                if e["name"] == "tuning.trial"]


def test_reentrancy_guard_is_per_thread(monkeypatch):
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    from pylops_mpi_tpu_torch.tuning import plan as tplan
    got = []
    tplan._tls.active = True
    try:
        assert ttune.get_plan("stack", shape=(8, 4), device="cpu") is None
        t = threading.Thread(target=lambda: got.append(
            ttune.get_plan("stack", shape=(8, 4), device="cpu")))
        t.start()
        t.join()
    finally:
        tplan._tls.active = False
    assert got[0] is not None and got[0].params == {"overlap": "off"}


def test_cpu_operator_keys_cpu_with_a_card_present(monkeypatch):
    # the fault: plans were keyed by card 0 whenever a card existed, so a
    # CPU operator's plan would replay on the card and the reverse
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a, **k: "FakeCard")
    assert ttune.plan_key("blockdiag", (8, 8), torch.float32,
                          device="cpu").endswith("|cpu:cpu")
    assert ttune.plan_key("blockdiag", (8, 8), torch.float32,
                          device="cuda").endswith("|cuda:FakeCard")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TRACE", "spans")
    rng = np.random.default_rng(3)
    pmtt.MPIBlockDiag([TMatrixMult(rng.standard_normal((6, 6)),
                                   device="cpu") for _ in range(2)])
    keys = [e["args"]["key"] for e in ttrace.get_events()
            if e["name"] == "tuning.plan"]
    assert keys and all(k.endswith("|cpu:cpu") for k in keys)


def _bd_pair(rng, n=4, m=12, k=9):
    blocks = [rng.standard_normal((m, k)) for _ in range(n)]
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks],
                           normal_path="two_sweep")
    return blocks, jop


def test_banked_two_sweep_plan_takes_two_sweeps(monkeypatch, tmp_path):
    rng = np.random.default_rng(11)
    blocks, jop = _bd_pair(rng)
    x = rng.standard_normal(4 * 9)
    ju, jq = jop.normal_matvec(pmt.DistributedArray.to_dist(x))
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    key = ttune.plan_key("blockdiag", (48, 36), torch.float64,
                         device="cpu")
    tcache.store(key, {"params": {"normal_path": "two_sweep"}})
    calls = []
    real = nk.normal_matvec
    monkeypatch.setattr(nk, "normal_matvec",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    top = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks])
    assert top._normal_path == "two_sweep" and not top.has_fused_normal
    u, q = top.normal_matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    assert calls == []
    for got, want in ((u, ju), (q, jq)):
        want = np.asarray(want.asarray())
        np.testing.assert_allclose(got.asarray(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    # explicit kwargs beat the plan
    fused = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks],
                              normal_path="fused")
    fused.normal_matvec(pmtt.DistributedArray.to_dist(x, device="cpu"))
    assert fused.has_fused_normal and calls == [1]
    # and with tuning off nothing is consulted
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "off")
    plain = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks])
    assert plain._normal_path is None and plain.has_fused_normal


@pytest.mark.parametrize("density", [0.05, 0.95])
def test_auto_sparse_matmult_tier_equals_jax(monkeypatch, density):
    rng = np.random.default_rng(13)
    A = np.where(rng.random((64, 48)) < density,
                 rng.standard_normal((64, 48)), 0.0)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TUNE", "on")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "on")
    jop = pmt.auto_sparse_matmult(A, mesh=make_mesh(1))
    top = pmtt.auto_sparse_matmult(A, device="cpu")
    jsparse = isinstance(jop, pmt.MPISparseMatrixMult)
    assert isinstance(top, pmtt.MPISparseMatrixMult) == jsparse
    assert jsparse == (density < 0.5)
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_TUNE", "off")
    assert not isinstance(pmtt.auto_sparse_matmult(A, device="cpu"),
                          pmtt.MPISparseMatrixMult)


@pytest.mark.parametrize("stall", [None, "64"])
def test_ca_auto_resolves_as_jax(monkeypatch, stall):
    rng = np.random.default_rng(17)
    blocks = [rng.standard_normal((8, 8)) + 8 * np.eye(8) for _ in range(4)]
    jop = pmt.MPIBlockDiag([JMatrixMult(b) for b in blocks])
    top = pmtt.MPIBlockDiag([TMatrixMult(b, device="cpu") for b in blocks])
    monkeypatch.setenv("PYLOPS_MPI_TPU_CA", "auto")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "auto")
    if stall:
        monkeypatch.setenv("PYLOPS_MPI_TPU_REDUCE_STALL", stall)
        monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_REDUCE_STALL", stall)
    from pylops_mpi_tpu_torch.parallel import mesh as tmesh
    tmesh.set_default_device("cpu")  # Op=None reads the default device
    try:
        for solver in ("cg", "cgls", "block_cg"):
            want = jca.resolve_mode(jop, solver)
            assert tca.resolve_mode(top, solver) == want
            assert want == ("pipelined" if stall else "off")
            assert tca.resolve_mode(None, solver) == \
                jca.resolve_mode(None, solver)
    finally:
        tmesh.set_default_device(None)
    assert tco.stall_signature() == ((("stall", 64),) if stall else ())


def test_reduce_stall_is_bitwise_inert(monkeypatch):
    g = torch.Generator().manual_seed(19)
    for shape, dt in [((), torch.float64), ((5,), torch.float32),
                      ((3, 4), torch.float64)]:
        k = torch.rand(shape, generator=g, dtype=dt) * 1e3
        assert tco.reduce_stall(k, 0) is k
        assert torch.equal(tco.reduce_stall(k, 37), k)
    # a pipelined CG with the stall armed: x bitwise the unstalled one
    rng = np.random.default_rng(23)
    blocks = [rng.standard_normal((8, 8)) for _ in range(3)]
    top = pmtt.MPIBlockDiag([TMatrixMult(b @ b.T + 8 * np.eye(8),
                                         device="cpu") for b in blocks])
    y = pmtt.DistributedArray.to_dist(rng.standard_normal(24), device="cpu")
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_CA", "pipelined")
    x0 = pmtt.cg(top, y, niter=12, tol=0.0)[0].array
    monkeypatch.setenv("PYLOPS_MPI_TPU_TORCH_REDUCE_STALL", "16")
    x1 = pmtt.cg(top, y, niter=12, tol=0.0)[0].array
    assert torch.equal(x0, x1)


def test_cli_quick_ends_in_json(tmp_path):
    out = tmp_path / "plans.json"
    env = {k: v for k, v in os.environ.items() if k not in _KNOBS}
    r = subprocess.run(
        [sys.executable, "-m", "pylops_mpi_tpu_torch.tuning", "--quick",
         "--device", "cpu", "--family", "blockdiag", "--family",
         "matrixmult", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout.strip().splitlines()[-1])
    assert summary["platform"] == "cpu" and summary["quick"]
    fams = [p["family"] for p in summary["plans"]]
    assert fams == ["blockdiag", "matrixmult", "matrixmult"]
    for p in summary["plans"]:
        assert p["provenance"] == "tuned" and p["key"].endswith(
            ("cpu:cpu", "cpu:cpu|grid(1, 1)"))
        assert all(t["ok"] for t in p["trials"])
    banked = json.loads(out.read_text())["plans"]
    assert set(banked) == {p["key"] for p in summary["plans"]}
