"""Generators drawn from the run's seed, one for each kind and index of
draw, so that every seed gives the same sizes and every rank draws exactly
the values a single card draws."""

from __future__ import annotations

import torch


def generator(seed: int, tag: int, index: int, device) -> torch.Generator:
    """A generator on ``device`` for the ``index``-th draw of kind ``tag``
    under ``seed`` (any whole number; it is folded below 2**63)."""
    key = (int(seed) * 1_000_003 + tag * 7_919 + index) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(key)
