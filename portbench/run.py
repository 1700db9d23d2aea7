"""The benchmark of ``pylops_mpi_tpu_torch``: one run of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result (JSON); the numbers the
run compared with the plain reference, each beside its limit, are the last
lines of standard error.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# every compiler cache at a fixed place inside the checkout, so that only a
# checkout's first run builds
_CACHE = ROOT / ".portbench_cache"
os.environ["TRITON_CACHE_DIR"] = str(_CACHE / "triton")
os.environ["CUDA_CACHE_PATH"] = str(_CACHE / "nv")
os.environ["TORCH_EXTENSIONS_DIR"] = str(_CACHE / "torch_extensions")
# one thread for the host's own math: the ranks' host threads are what
# pace a small iteration, and they share the host's cores
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# no library the program uses may load JAX
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
sys.path.insert(0, str(ROOT))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
