#!/usr/bin/env python3
"""Where the normal-product kernel's time goes, on one NVIDIA GPU.

    python3 scripts/normal_kernel_split.py

Builds two patched copies of ``pylops_mpi_tpu_torch/csrc/normal_matvec.cu``
with the package's own nvcc flags, for f32 and bf16 storage at the
main path's register bucket only:

- "copy only": the consumer warps wait for each ring stage and release it
  without reading it, so the time is the producer's bulk-copy stream;
- "arithmetic only": the producer signals each stage without copying, so
  the time is the consumers' work on whatever the ring holds.

It times both beside the kernel itself at the main path's shape, 32
blocks of 4096x4096, with the plan the wrapper picks on this card. With
the ring overlapping the two, the kernel takes about the longer of them;
where both are near the kernel's time, neither side alone holds it back.
Then it times the kernel alone on shallower stacks of the same blocks
(nblk 1 to 16), where each block is split over more CTAs and the fixed
costs (launches, ring fill, the segment reduction) weigh more. It prints
the card (name and power limit) and one JSON line. Without CUDA or nvcc
it exits non-zero.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NBLK, NBLOCK, REPS = 32, 4096, 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)


def patched_sources(src: str):
    """The two variants of the kernel source, each cut to the f32 and
    bf16 instantiations at kc 2 and 4."""
    def sub(s, old, new):
        if old not in s:
            raise RuntimeError(f"normal_matvec.cu no longer holds {old!r}")
        return s.replace(old, new)

    src = re.sub(r"    case (1|8|24): return f\(std::integral_constant<int, \d+>\{\}\);\n",
                 "", src)
    src = sub(src, "    case 2: return f(__half{}, float{});\n"
                   "    case 3: return f(double{}, double{});\n", "")
    return {
        "copy_only": sub(src, "for (int gr = 0; gr < rows; gr += kGroup) {",
                         "for (int gr = 0; false; gr += kGroup) {"),
        "arithmetic_only": sub(src, "if (bulk && lane == 0) {",
                               "if (true) { mbar_arrive(&full[stage]); } "
                               "else if (bulk && lane == 0) {"),
    }


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("normal_kernel_split.py needs a CUDA device", file=sys.stderr)
        return 3
    from pylops_mpi_tpu_torch.ops import _build
    from pylops_mpi_tpu_torch.ops import normal_kernels as nk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(card, flush=True)
    out = _build.BUILD_DIR / "split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in patched_sources(
            (_build.CSRC / "normal_matvec.cu").read_text()).items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _build.build_all()
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).normal_matvec_launch
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 5
                       + [ctypes.c_int] * 8 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn

    def cuda_ms(fn):
        for _ in range(2):
            fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / REPS

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    result = {"card": card}
    for dt in (torch.float32, torch.bfloat16):
        A = torch.randn((NBLK, NBLOCK, NBLOCK), generator=g, device=dev).to(dt)
        X = torch.randn((NBLK, NBLOCK), generator=g, device=dev)
        U, Q = torch.empty_like(X), torch.empty_like(X)
        p = nk.device_plan(NBLK, NBLOCK, NBLOCK, dt, torch.cuda.current_device())
        scratch = torch.empty((p.scratch_slots, NBLOCK), device=dev)

        def variant(fn, dt=dt, A=A, X=X, U=U, Q=Q, p=p, scratch=scratch):
            err = fn(nk._DTYPE_CODES[dt], p.kc, A.data_ptr(), X.data_ptr(),
                     U.data_ptr(), Q.data_ptr(), scratch.data_ptr(),
                     NBLK, NBLOCK, NBLOCK, p.ctas,
                     p.rows_per_stage, p.stages, p.stage_bytes, p.smem_bytes,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"variant launch failed: error {err}")

        row = {"kernel_ms": cuda_ms(lambda: nk.normal_matvec(A, X))}
        for name, fn in fns.items():
            row[f"{name}_ms"] = cuda_ms(lambda fn=fn: variant(fn))
        row["kernel_ms_again"] = cuda_ms(lambda: nk.normal_matvec(A, X))
        row["bound_ms"] = A.numel() * A.element_size() / HBM_BYTES_PER_S * 1e3
        row["plan"] = dict(ctas=p.ctas, ctas_per_sm=p.ctas_per_sm,
                           stages=p.stages, rows_per_stage=p.rows_per_stage,
                           stage_bytes=p.stage_bytes)
        name = str(dt).split(".")[1]
        result[name] = row
        print(f"{name}: kernel {row['kernel_ms']:.4f}/"
              f"{row['kernel_ms_again']:.4f} ms, copy only "
              f"{row['copy_only_ms']:.4f} ms, arithmetic only "
              f"{row['arithmetic_only_ms']:.4f} ms, A over the memory rate "
              f"{row['bound_ms']:.4f} ms", flush=True)
        depth = {}
        for nblk in (1, 2, 4, 8, 16):
            Ad, Xd = A[:nblk].contiguous(), X[:nblk].contiguous()
            depth[nblk] = dict(
                kernel_ms=cuda_ms(lambda: nk.normal_matvec(Ad, Xd)),
                bound_ms=Ad.numel() * Ad.element_size() / HBM_BYTES_PER_S
                * 1e3)
            del Ad, Xd
        row["shallower"] = depth
        print(f"{name} by nblk (kernel ms, bound ms): "
              + ", ".join(f"{k}: {v['kernel_ms']:.4f}, {v['bound_ms']:.4f}"
                          for k, v in depth.items()), flush=True)
        del A, X, U, Q, scratch
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
