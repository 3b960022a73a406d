"""Stateless per-item augmentation randomness.

Copy of ``upflow_pytorch_tpu/data/rng.py`` (numpy only): every item draws
from a fresh generator derived from ``(seed, epoch, index)``, so
augmentation is the same whatever the loader's thread scheduling, and a
resumed run re-creates the same crops, flips and swaps.
"""

from __future__ import annotations

import numpy as np


def item_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    """Deterministic per-item generator from (seed, epoch, index)."""
    return np.random.Generator(
        np.random.PCG64(np.random.SeedSequence((seed, epoch, index))))
