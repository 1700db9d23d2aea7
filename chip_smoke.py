#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (pylops_mpi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. the card's name and power limit (nvidia-smi), and the build of every
   kernel in ``pylops_mpi_tpu_torch/csrc`` (one nvcc per source, run at
   once);
2. each kernel against its plain PyTorch version on the card, at a small
   ragged shape and at the main path's full shape, with times for the
   kernel, the plain version and a PyTorch library yardstick;
3. the main path as a user drives it: CGLS on MPIBlockDiag of 32
   4096×4096 MatrixMult blocks (``bench.py:make_problem`` style data made
   on the card from a seeded generator), 50 iterations of the one-sweep
   ``normal=True`` schedule with f32 storage and with bf16 storage, and
   the classic two-sweep schedule with f32 storage; each run must reach
   the known model and must have gone through the kernel;
4. a small f64 problem solved on the card and on the CPU, which must
   agree.

It prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory without the package beside it, it exits non-zero before
printing any result.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

NBLK, NBLOCK, NITER = 32, 4096, 50
REPS = 20
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
SRC = "pylops_mpi_tpu_torch/csrc/normal_matvec.cu"
REPLACES = {"float32": "pylops_mpi_tpu/ops/pallas_kernels.py:222",
            "bfloat16": "pylops_mpi_tpu/ops/pallas_kernels.py:240",
            "float16": "pylops_mpi_tpu/ops/pallas_kernels.py:240",
            "float64": "pylops_mpi_tpu/ops/pallas_kernels.py:222"}
# kernel vs plain version, max |err| over max |plain|: both accumulate at
# f32 (f64 for f64 blocks), in different orders, over n terms
TOL = {"float32": 1e-4, "bfloat16": 1e-4, "float16": 1e-4, "float64": 1e-10}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def cuda_ms(fn, reps=REPS):
    """Mean milliseconds of ``fn()`` over ``reps`` back-to-back calls,
    timed with CUDA events after two warm-up calls."""
    import torch
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(nk, A, X):
    """Kernel vs plain version on the card: (max abs err, max rel err)."""
    import torch
    u, q = nk.normal_matvec(A, X)
    torch.cuda.synchronize()
    u0, q0 = nk.normal_matvec_plain(A, X)
    abs_err = max(float((u - u0).abs().max()), float((q - q0).abs().max()))
    rel = max(float((u - u0).abs().max() / u0.abs().max()),
              float((q - q0).abs().max() / q0.abs().max()))
    if not (torch.isfinite(u).all() and torch.isfinite(q).all()):
        raise RuntimeError("kernel produced non-finite values")
    return abs_err, rel


def bound_ms(nblk, m, n, itemsize):
    """Least time for one normal product: A read once plus x read and
    u, q written once, over the memory rate; 4·m·n operations per block
    at the f32 rate (narrow blocks are widened to f32)."""
    xbytes = 4 if itemsize < 8 else 8
    nbytes = nblk * m * n * itemsize + nblk * (2 * n + m) * xbytes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4.0 * nblk * m * n / (F32_OPS_PER_S / (2 if itemsize == 8 else 1)) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_run(torch, fn):
    """Device time by kernel over one call of ``fn`` under
    ``torch.profiler``: (wall ms, device-busy ms, top kernels). Only
    device (kernel) events count; wall time includes the profiler's own
    overhead, so the idle share it implies is an upper bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if e.device_type == DeviceType.CUDA and us > 0:
            rows.append((us / 1e3, e.key[:60], e.count))
    rows.sort(reverse=True)
    return wall * 1e3, sum(r[0] for r in rows), rows[:6]


def make_problem(torch, device, seed=0):
    """bench.py:make_problem on the card: diagonally dominant blocks
    quantized to the bf16 grid (the f32 and bf16 runs solve the same
    system), a known model and its exact data."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn((NBLK, NBLOCK, NBLOCK), generator=g, device=device)
    A /= math.sqrt(NBLOCK)
    A.diagonal(dim1=1, dim2=2).add_(4.0)
    A = A.to(torch.bfloat16).to(torch.float32)
    xtrue = torch.randn((NBLK, NBLOCK), generator=g, device=device)
    y = torch.bmm(A, xtrue.unsqueeze(-1)).reshape(-1)
    return A, xtrue.reshape(-1), y


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "pylops_mpi_tpu_torch" / "__init__.py").is_file():
        log("chip_smoke.py: the package pylops_mpi_tpu_torch is not beside "
            "this script; run it from the root of the repository")
        return 2
    sys.path.insert(0, str(here))
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke.py: torch.cuda.is_available() is False; this script "
            "runs the port on a CUDA device only")
        return 3

    import pylops_mpi_tpu_torch as pmtt
    from pylops_mpi_tpu_torch.ops import _build
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk
    from pylops_mpi_tpu_torch.ops.local import MatrixMult
    if Path(pmtt.__file__).resolve().parent != here / "pylops_mpi_tpu_torch":
        raise RuntimeError(f"imported {pmtt.__file__}, not the checkout's "
                           "package")
    dev = torch.device("cuda")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")

    # 1. card and build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    t0 = time.perf_counter()
    names = _build.build_all()
    print(f"build: {names} in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, out in _build.BUILD_LOGS.items():
        log(f"--- nvcc {name}.cu ---\n{out}")

    # 2. kernels against their plain versions
    g = torch.Generator(device=dev).manual_seed(1)
    stats = {}
    for shape in [(3, 1000, 777), (NBLK, NBLOCK, NBLOCK)]:
        for dt in (torch.float32, torch.bfloat16, torch.float16, torch.float64):
            if dt == torch.float64 and shape[1] == NBLOCK:
                continue  # f64 is a correctness path only
            name = str(dt).split(".")[1]
            xdt = torch.float64 if dt == torch.float64 else torch.float32
            A = torch.randn(shape, generator=g, device=dev).to(dt)
            X = torch.randn((shape[0], shape[2]), generator=g, device=dev,
                            dtype=xdt)
            abs_err, rel = compare(nk, A, X)
            ok = rel <= TOL[name]
            print(f"kernel vs plain {name} {shape}: max rel err {rel:.3e} "
                  f"(tol {TOL[name]:.0e}) {'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise RuntimeError(f"normal_matvec[{name}] {shape} disagrees "
                                   f"with its plain version: {rel:.3e}")
            if shape[1] != NBLOCK:
                continue
            Xc = X.unsqueeze(-1).to(dt)
            At = A.transpose(1, 2)

            def library(A=A, Xc=Xc, At=At):
                return torch.bmm(At, torch.bmm(A, Xc))

            kms = cuda_ms(lambda: nk.normal_matvec(A, X))
            pms = cuda_ms(lambda: nk.normal_matvec_plain(A, X))
            lms = cuda_ms(library)
            kms2 = cuda_ms(lambda: nk.normal_matvec(A, X))
            bms, bby = bound_ms(*shape, A.element_size())
            stats[name] = dict(shape=list(shape), max_abs_err=abs_err,
                               max_err=rel, tol=TOL[name], ms=min(kms, kms2),
                               kernel_ms_runs=[kms, kms2], plain_ms=pms,
                               library_ms=lms, bound_ms=bms, bound_by=bby)
            print(f"  {name}: kernel {kms:.3f}/{kms2:.3f} ms, plain {pms:.3f} "
                  f"ms, library {lms:.3f} ms, bound {bms:.3f} ms ({bby})",
                  flush=True)
            del A, X, Xc, At
            torch.cuda.empty_cache()

    # 3. the main path
    A, xtrue, y_t = make_problem(torch, dev)
    y = pmtt.DistributedArray.to_dist(y_t)
    runs = {}
    for label, cdt, normal, limit in [
            ("normal_f32", None, True, 1e-4),
            ("normal_bf16", torch.bfloat16, True, 1e-3),
            ("classic_f32", None, False, 1e-4)]:
        Op = pmtt.MPIBlockDiag([MatrixMult(A[i]) for i in range(NBLK)],
                               compute_dtype=cdt)
        pmtt.cgls(Op, y, niter=2, tol=0.0, normal=normal)  # warm-up
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):  # host-clock noise: keep the fastest of three
            nk.reset_launches()
            t0 = time.perf_counter()
            x, istop, iiter, r1, r2, cost = pmtt.cgls(
                Op, y, niter=NITER, tol=0.0, normal=normal)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            launches = nk.launches
            if normal and launches < iiter:
                raise RuntimeError(f"{label}: {launches} kernel launches for "
                                   f"{iiter} iterations: the path missed the "
                                   "kernel")
        wall = min(walls)
        xv = x.array
        if xv.shape != xtrue.shape or not bool(torch.isfinite(xv).all()):
            raise RuntimeError(f"{label}: non-finite or misshapen solution")
        rel_err = float(torch.linalg.vector_norm(xv - xtrue)
                        / torch.linalg.vector_norm(xtrue))
        runs[label] = dict(rel_err=rel_err, iiter=iiter, istop=istop,
                           iters_per_s=iiter / wall, wall_s=walls,
                           launches=launches)
        print(f"cgls {label}: rel_err {rel_err:.3e} (limit {limit:.0e}), "
              f"{iiter} iters in {wall:.4f} s (best of {walls}) = "
              f"{iiter / wall:.1f} iters/s, "
              f"normal kernel launches {launches}", flush=True)
        if rel_err > limit:
            raise RuntimeError(f"{label}: rel_err {rel_err:.3e} > {limit:.0e}")
        if not normal and launches != 0:
            raise RuntimeError(f"{label}: classic path launched the kernel")
        wall_ms, busy_ms, top = profile_run(
            torch, lambda: pmtt.cgls(Op, y, niter=10, tol=0.0, normal=normal))
        runs[label].update(profile_wall_ms=wall_ms, profile_device_ms=busy_ms,
                           profile_top=top)
        print(f"  profile, 10 iterations: device busy {busy_ms:.3f} ms of "
              f"{wall_ms:.3f} ms wall; top kernels (ms, name, count): {top}",
              flush=True)
        del Op, x
        torch.cuda.empty_cache()
    del A
    torch.cuda.empty_cache()

    # 4. a small problem on the card against the same on the CPU
    gen = torch.Generator().manual_seed(2)
    blocks = [torch.randn(64, 48, generator=gen, dtype=torch.float64)
              for _ in range(8)]
    yb = torch.randn(8 * 64, generator=gen, dtype=torch.float64)
    sols = []
    for d in ("cuda", "cpu"):
        Op = pmtt.MPIBlockDiag([MatrixMult(b, device=d) for b in blocks])
        yy = pmtt.DistributedArray.to_dist(yb, device=d)
        sols.append(pmtt.cgls(Op, yy, niter=20, tol=0.0, normal=True)[0]
                    .asarray())
    small = float(abs(sols[0] - sols[1]).max() / abs(sols[1]).max())
    print(f"small f64 problem, card vs CPU: max rel diff {small:.3e} "
          "(tol 1e-9)", flush=True)
    if not small <= 1e-9:
        raise RuntimeError(f"card and CPU disagree: {small:.3e}")

    kernels = []
    for name, run in (("float32", "normal_f32"), ("bfloat16", "normal_bf16")):
        s = stats[name]
        r = runs[run]
        kernels.append(dict(
            name=f"normal_matvec[{name}]", route="cuda", source=SRC,
            replaces=REPLACES[name], launches=r["launches"],
            launches_per_iter=r["launches"] / r["iiter"],
            max_abs_err=s["max_abs_err"], max_err=s["max_err"], tol=s["tol"],
            ms=s["ms"], kernel_ms=s["ms"], kernel_ms_runs=s["kernel_ms_runs"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by=s["bound_by"], library_ms=s["library_ms"],
            shape=s["shape"], dtype=name))
    print(json.dumps({"card": card, "runs": runs,
                      "float16_kernel": stats["float16"]}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
