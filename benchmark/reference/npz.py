"""Reads an UPFlow parameter snapshot (``.npz`` of '/'-joined flax paths,
kernels HWIO) into the reference's flat parameter dict.

Leaf names are the module path without ``params/`` and ``/conv``, then
``.weight`` (OIHW) or ``.bias``: ``flow_estimators/conv1.weight``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def leaf_name(path: str) -> str:
    parts = path.split("/")
    if parts[0] != "params" or parts[-2] != "conv" or parts[-1] not in (
            "kernel", "bias"):
        raise ValueError("not a conv parameter path: %r" % path)
    suffix = ".weight" if parts[-1] == "kernel" else ".bias"
    return "/".join(parts[1:-2]) + suffix


def load_params(path: str, device) -> Dict[str, torch.Tensor]:
    """The snapshot's parameters as fp32 tensors on ``device``."""
    out = {}
    with np.load(path) as data:
        for key in data.files:
            arr = np.asarray(data[key], np.float32)
            if key.endswith("/kernel"):
                arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[leaf_name(key)] = torch.from_numpy(
                np.ascontiguousarray(arr)).to(device)
    return out
