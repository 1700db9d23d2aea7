"""Offline tuning sweep: ``python -m pylops_mpi_tpu_torch.tuning``.

PyTorch counterpart of ``python -m pylops_mpi_tpu.tuning``: measures the
operator families' plan spaces shape by shape and banks the winners into
a plan cache (``--out``, else ``PYLOPS_MPI_TPU_TORCH_TUNE_CACHE``), so
that later processes with ``PYLOPS_MPI_TPU_TORCH_TUNE=on`` replay them
without a trial.

    python -m pylops_mpi_tpu_torch.tuning --out plans.json [--quick]
        [--defaults] [--ladder] [--family F ...] [--repeats N]
        [--device cuda|cpu] [--main-path] [--storage f32|bf16]

``--quick`` takes small shapes (a CPU rehearsal), ``--ladder`` quick
shapes off the card and full ones on it, ``--defaults`` banks the seed's
picks without a trial, ``--main-path`` the main path's widths
(:data:`MAIN_PATH_SHAPES`: slice 1's 32 blocks of 4096², BASELINE #3's
widened SUMMA), ``--storage`` the block stacks' storage dtype. The plan
key carries the operator's dtype, not its storage's: bank each storage
in a cache file of its own.

A case whose space lists one candidate (on the card: the families whose
only axis the port does not act on yet, and SUMMA on a 1×1 grid) has
nothing to race and is recorded as skipped, with no plan banked.

Progress goes to stderr; the last line of stdout is one JSON summary,
with each family's winning params, provenance and trials. A case whose
trial fails is recorded with its error and banks nothing; the sweep
goes on to the next case and then exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _eprint(msg: str) -> None:
    print(f"[tune] {msg}", file=sys.stderr, flush=True)


# the main path's widths, at which chip_smoke.py phase 25 races the
# normal kernel: slice 1's CGLS operator and slice 8's SUMMA
MAIN_PATH_SHAPES = {
    "blockdiag": [(32, 4096)],
    "matrixmult": [(32768, 16384, 64)],
}


def _storage(name):
    import torch
    return {"f32": None, "bf16": torch.bfloat16}[name]


# ------------------------------------------------------------- factories
def _summa_case(N, K, M, dev):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.matrixmult import _MPISummaMatrixMult

    A = torch.linspace(-1.0, 1.0, N * K, dtype=torch.float32,
                       device=dev).reshape(N, K)
    x = torch.linspace(-1.0, 1.0, K * M, dtype=torch.float32, device=dev)

    def factory(params):
        op = _MPISummaMatrixMult(A, M, dtype=torch.float32,
                                 schedule=params["schedule"],
                                 overlap=params["overlap"], device=dev)
        dx = DistributedArray.to_dist(x, device=dev)
        return lambda: op.matvec(dx).array

    return factory


def _fft_case(dims, dev):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.fft import MPIFFT2D

    n = int(dims[0]) * int(dims[1])
    x = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=dev)

    def factory(params):
        op = MPIFFT2D(dims, overlap=params["overlap"],
                      comm_chunks=max(1, int(params["comm_chunks"])))
        dx = DistributedArray.to_dist(
            x, local_shapes=op.model_local_shapes, device=dev)
        return lambda: op.matvec(dx).array

    return factory


def _blocks(nblk, n, dev):
    """The JAX sweep's blocks, made on the device: ``L + (i+1)·I`` with
    ``L`` a linspace over [-1, 1]."""
    import torch
    L = torch.linspace(-1.0, 1.0, n * n, dtype=torch.float32,
                       device=dev).reshape(n, n)
    eye = torch.eye(n, dtype=torch.float32, device=dev)
    return [L + eye * (i + 1) for i in range(nblk)]


def _blockdiag_case(nblk, n, dev, storage):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.blockdiag import MPIBlockDiag
    from ..ops.local import MatrixMult

    mats = _blocks(nblk, n, dev)
    x = torch.linspace(-1.0, 1.0, nblk * n, dtype=torch.float32,
                       device=dev)

    def factory(params):
        op = MPIBlockDiag([MatrixMult(m) for m in mats],
                          compute_dtype=storage,
                          normal_path=params["normal_path"])
        dx = DistributedArray.to_dist(x)
        return lambda: op.normal_matvec(dx)[0].array

    return factory


def _stack_case(nblk, n, dev):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.local import MatrixMult
    from ..ops.stack import MPIVStack

    L = torch.linspace(-1.0, 1.0, n * n, dtype=torch.float32,
                       device=dev).reshape(n, n)
    y = torch.linspace(-1.0, 1.0, nblk * n, dtype=torch.float32,
                       device=dev)

    def factory(params):
        op = MPIVStack([MatrixMult(L) for _ in range(nblk)],
                       overlap=params["overlap"])
        dy = DistributedArray.to_dist(y)
        return lambda: op.rmatvec(dy).array

    return factory


def _derivative_case(dims, dev):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.derivatives import MPIFirstDerivative

    n = int(dims[0]) * int(dims[1])
    x = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=dev)

    def factory(params):
        # the ghost strategy: in a world of one both candidates run the
        # bulk exchange (the card lists one and skips the case); across
        # ranks overlap="on" posts the ghosts before the interior pass
        op = MPIFirstDerivative(dims, overlap=params["overlap"])
        dx = DistributedArray.to_dist(x)
        return lambda: op.matvec(dx).array

    return factory


def _halo_case(dims, dev):
    import torch
    from ..distributedarray import DistributedArray
    from ..ops.halo import MPIHalo

    n = int(dims[0]) * int(dims[1])
    x = torch.linspace(-1.0, 1.0, n, dtype=torch.float64, device=dev)

    def factory(params):
        op = MPIHalo(dims, 2, overlap=params["overlap"])
        dx = DistributedArray.to_dist(x)
        return lambda: op.matvec(dx).array

    return factory


# --------------------------------------------------------------- the sweep
def _shape_sets(quick: bool):
    """Each family's shapes: small ones (a CPU rehearsal) or the JAX
    package's full set."""
    if quick:
        return {
            "matrixmult": [(48, 64, 8), (64, 48, 32)],
            "fft": [(64, 32)],
            "blockdiag": [(8, 32)],
            "stack": [(8, 32)],
            "derivative": [(64, 16)],
            "halo": [(64, 16)],
        }
    return {
        "matrixmult": [(2048, 2048, 64), (4096, 4096, 64),
                       (1024, 4096, 64)],
        "fft": [(512, 512), (1024, 256)],
        "blockdiag": [(8, 1024), (8, 2048)],
        "stack": [(8, 1024)],
        "derivative": [(4096, 512)],
        "halo": [(4096, 512)],
    }


def run_sweep(out_path, quick=False, defaults_only=False, families=None,
              repeats=3, device="cuda", main_path=False, storage="f32"):
    from ..parallel.mesh import resolve_device, world_size
    from ..utils.deps import apply_environment
    from . import cache, space
    apply_environment()
    dev = resolve_device(device)
    n_dev = world_size()
    shapes = dict(_shape_sets(quick))
    if main_path:
        shapes.update(MAIN_PATH_SHAPES)
    families = families or list(shapes)
    summary = {"bench": "tune_sweep", "platform": dev.type,
               "n_devices": n_dev, "quick": bool(quick),
               "main_path": bool(main_path), "storage": storage,
               "defaults_only": bool(defaults_only), "plans": []}
    for fam in families:
        sp = space.space_for(fam)
        if sp is None:
            continue
        for shape in shapes.get(fam, []):
            t0 = time.time()
            try:
                entry = _tune_one(fam, shape, n_dev, dev, sp, out_path,
                                  defaults_only, repeats, storage)
            except Exception as e:  # one bad case must not end the sweep
                entry = {"family": fam, "shape": list(shape),
                         "error": repr(e)[:300]}
            entry["seconds"] = round(time.time() - t0, 2)
            summary["plans"].append(entry)
            what = entry.get("params", entry.get("error",
                                                 entry.get("skipped")))
            _eprint(f"{fam} {shape}: {what} "
                    f"[{entry.get('provenance', '-')}] "
                    f"{entry['seconds']}s")
            if dev.type == "cuda":
                import torch
                torch.cuda.empty_cache()
    summary["cache"] = out_path or cache.cache_path() or "(memory only)"
    return summary


def _tune_one(fam, shape, n_dev, dev, sp, out_path, defaults_only,
              repeats, storage):
    import torch
    from . import cache, plan, search, space

    extra = {}
    if fam == "matrixmult":
        from ..parallel.mesh import best_grid_2d
        extra = {"grid": best_grid_2d(n_dev)}
        factory = _summa_case(*shape, dev)
        ctx_shape, dtype = shape, torch.float32
    elif fam == "fft":
        factory = _fft_case(shape, dev)
        ctx_shape, dtype = shape, torch.complex128
    elif fam == "blockdiag":
        nblk, n = shape
        st = _storage(storage)
        factory = _blockdiag_case(nblk, n, dev, st)
        ctx_shape, dtype = (nblk * n, nblk * n), torch.float32
        itemsize = (st or torch.float32).itemsize
        extra = {"fused_available": True,
                 "a_bytes": float(nblk * n * n * itemsize)}
    elif fam == "stack":
        nblk, n = shape
        factory = _stack_case(nblk, n, dev)
        ctx_shape, dtype = (nblk * n, n), torch.float32
    elif fam == "derivative":
        factory = _derivative_case(shape, dev)
        ctx_shape, dtype = shape, torch.float64
    elif fam == "halo":
        factory = _halo_case(shape, dev)
        ctx_shape, dtype = shape, torch.float64
    else:
        raise ValueError(f"unknown family {fam!r}")

    key = plan.plan_key(fam, ctx_shape, dtype, n_dev, None, extra, dev)
    platform, chip = plan._chip_kind(dev)
    ctx = {"op": fam, "shape": tuple(int(s) for s in ctx_shape),
           "dtype": dtype, "n_dev": n_dev, "axes": (),
           "platform": platform, "chip": chip, "extra": extra}
    if not defaults_only and len(space.candidates(sp, ctx)) < 2:
        return {"family": fam, "shape": list(shape), "key": key,
                "skipped": "one candidate: nothing to race"}
    if defaults_only:
        params = space.rank(sp, ctx)[0]
        provenance, trials = "costmodel", []
    else:
        plan._tls.active = True  # candidates never consult the tuner
        try:
            params, trials = search.measure_candidates(sp, ctx, factory,
                                                       repeats=repeats)
        finally:
            plan._tls.active = False
        provenance = "tuned"
        if params is None:
            params = space.rank(sp, ctx)[0]
            provenance = "costmodel"
    cache.store(key, {"params": params, "provenance": provenance,
                      "trials": trials, "created_s": time.time()},
                path=out_path)
    if fam == "fft" and params.get("comm_chunks"):
        plan.record_chunk_plan(shape[-1], n_dev, params["comm_chunks"],
                               path=out_path)
    return {"family": fam, "shape": list(shape), "key": key,
            "params": params, "provenance": provenance,
            "n_trials": sum(1 for t in trials if t.get("ok")),
            "trials": [{k: t.get(k) for k in ("params", "ok", "best_s",
                                               "mean_s", "compile_s",
                                               "error") if k in t}
                       for t in trials]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m pylops_mpi_tpu_torch.tuning",
        description="Offline autotuning sweep; banks a plan cache")
    ap.add_argument("--out", default=None,
                    help="cache file to bank plans into (default: "
                         "$PYLOPS_MPI_TPU_TORCH_TUNE_CACHE)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes (a CPU rehearsal)")
    ap.add_argument("--defaults", action="store_true",
                    help="bank the seed's picks without measuring")
    ap.add_argument("--ladder", action="store_true",
                    help="quick shapes off the card, full shapes on it")
    ap.add_argument("--family", action="append", default=None,
                    help="limit to one family (repeatable)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda",
                    help="device the candidates run on (default cuda)")
    ap.add_argument("--main-path", action="store_true",
                    help="the main path's widths (MAIN_PATH_SHAPES)")
    ap.add_argument("--storage", choices=("f32", "bf16"), default="f32",
                    help="storage dtype of the block stacks")
    args = ap.parse_args(argv)

    quick = args.quick
    if args.ladder and not quick:
        quick = not args.device.startswith("cuda")
    summary = run_sweep(args.out, quick=quick, defaults_only=args.defaults,
                        families=args.family, repeats=args.repeats,
                        device=args.device, main_path=args.main_path,
                        storage=args.storage)
    print(json.dumps(summary), flush=True)
    return 1 if any("error" in p for p in summary["plans"]) else 0


if __name__ == "__main__":
    sys.exit(main())
