"""Read the single-file ``.npz`` parameter snapshots (for example
``assets/synthetic_trained.npz``): '/'-joined flax param paths such as
``params/conv_1x1_0/conv/kernel`` mapped to numpy arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np


def load_npz_flat(path: str) -> Dict[str, np.ndarray]:
    """Returns the snapshot as a flat ``{'/'-path: ndarray}`` dict."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}
