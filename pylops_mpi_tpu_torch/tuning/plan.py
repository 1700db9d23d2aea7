"""Plan keys and the serving pool's consult of the plan cache.

PyTorch counterpart of three functions of
``pylops_mpi_tpu/tuning/plan.py:121-193``: :func:`shape_bucket`,
:func:`plan_key` and :func:`cached_batch_widths`. Keys have the JAX
package's layout, ``op|s<bucket>|<dtype>|mesh[<axes>]x<n>|<platform>:
<chip>`` with optional ``|grid(..)``, ``|b<K>`` and ``|t<topology>``
segments; the chip half is ``cuda:<device name>`` on a card and
``cpu:cpu`` without one. ``get_plan`` and the search that fills the
cache are ROADMAP.md §A.7.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from . import cache as _cache

__all__ = ["shape_bucket", "plan_key", "cached_batch_widths"]


def shape_bucket(shape) -> Tuple[int, ...]:
    """The next power of two of each dimension: nearby shapes share a
    plan."""
    out = []
    for s in np.atleast_1d(shape):
        s = max(1, int(s))
        out.append(1 << (s - 1).bit_length())
    return tuple(out)


def _chip_kind() -> Tuple[str, str]:
    """(platform, device name) of card 0, or ``("cpu", "cpu")``."""
    try:
        import torch
        if torch.cuda.is_available():
            return "cuda", torch.cuda.get_device_name(0)
    except Exception:
        pass
    return "cpu", "cpu"


def _dtype_name(dtype) -> str:
    if dtype is None:
        return "f32"
    name = str(dtype)
    if name.startswith("torch."):
        return name[len("torch."):]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return name


def plan_key(op: str, shape, dtype=None, n_dev: Optional[int] = None,
             axes=None, extra: Optional[Dict] = None) -> str:
    """The cache key of one plan: operator family, shape bucket, dtype,
    mesh axes and size, chip; ``extra`` may add the grid, the block
    width (``batch``, omitted for 1) and a topology."""
    platform, chip = _chip_kind()
    bucket = "x".join(str(b) for b in shape_bucket(shape))
    ax = ",".join(str(a) for a in (axes or ()))
    nd = int(n_dev or 1)
    key = f"{op}|s{bucket}|{_dtype_name(dtype)}|mesh[{ax}]x{nd}|" \
          f"{platform}:{chip}"
    if extra and extra.get("grid"):
        key += f"|grid{tuple(int(g) for g in extra['grid'])}"
    if extra and extra.get("batch") and int(extra["batch"]) != 1:
        key += f"|b{int(extra['batch'])}"
    if extra and extra.get("topology"):
        key += f"|t{extra['topology']}"
    return key


def cached_batch_widths(op: str, path: Optional[str] = None) -> list:
    """The block widths K with a plan banked for operator family ``op``
    (sorted; 1 for a key without a ``|b<K>`` segment; an unparseable
    segment is skipped): the widths real traffic used, which the
    serving pool prewarms."""
    widths = set()
    prefix = op + "|"
    for key in _cache.cached_keys(path):
        if not key.startswith(prefix):
            continue
        k = 1
        for seg in key.split("|")[1:]:
            if len(seg) > 1 and seg[0] == "b" and seg[1:].isdigit():
                k = int(seg[1:])
        widths.add(k)
    return sorted(widths)
