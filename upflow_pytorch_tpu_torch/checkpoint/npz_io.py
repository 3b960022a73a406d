"""Single-file ``.npz`` parameter snapshots (for example
``assets/synthetic_trained.npz``): '/'-joined flax param paths such as
``params/conv_1x1_0/conv/kernel`` mapped to numpy arrays, the JAX
package's ``checkpoint/npz_io.py`` format, so a snapshot goes both ways
between the two packages."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch.nn as nn

from upflow_pytorch_tpu_torch.checkpoint.convert import torch_to_flax_flat


def load_npz_flat(path: str) -> Dict[str, np.ndarray]:
    """Returns the snapshot as a flat ``{'/'-path: ndarray}`` dict."""
    with np.load(path) as data:
        return {k: np.asarray(data[k]) for k in data.files}


def save_params_npz(path: str, model: nn.Module) -> None:
    """Writes the model's parameters as a snapshot that the JAX package's
    strict ``load_params_npz`` reads (kernels HWIO)."""
    np.savez_compressed(path, **torch_to_flax_flat(
        dict(model.named_parameters())))
