"""What a problem builder hands the harness."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List

import torch

from portbench.harness.bounds import Bound


@dataclass
class Range:
    """A ``record_function`` range the harness opens around
    ``getattr(owner, method)`` in a traced run; ``bound`` is one call's."""
    owner: Any
    method: str
    name: str
    bound: Bound


@dataclass
class Problem:
    """The system under test as one rank holds it.

    ``op`` and the data vectors ``rhs`` go to ``pylops_mpi_tpu_torch.cgls``;
    ``data_rows`` are this rank's rows of each data vector as the
    benchmark made them (``(n_rhs, rows)``, f32), which the reference is
    given once gathered; ``model_rows(x)`` gives this rank's rows of a
    solution; ``resolved`` names the program's own choices for this
    operator (printed, not measured)."""
    op: Any
    rhs: List[Any]
    data_rows: torch.Tensor
    model_rows: Callable[[Any], torch.Tensor]
    damp: float = 0.0
    ranges: List[Range] = field(default_factory=list)
    resolved: dict = field(default_factory=dict)
