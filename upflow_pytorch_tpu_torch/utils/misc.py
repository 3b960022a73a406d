"""Misc plumbing utilities.

Port of ``upflow_pytorch_tpu/utils/misc.py``, the reference's grab-bag
(``utils/tools.py:254-280,1634-1730``): the numpy and file helpers are
copies; ``to_device_batch`` moves a host batch to torch tensors on a
device.
"""

from __future__ import annotations

import os
import pickle
import zipfile
from typing import Any

import numpy as np
import torch


def im_norm(img: np.ndarray) -> np.ndarray:
    """Rescale to [0, 255] for display (tools.py:1717-1725)."""
    img = np.asarray(img, np.float64)
    lo, hi = img.min(), img.max()
    if hi - lo < 1e-12:
        return np.zeros_like(img)
    return (img - lo) / (hi - lo) * 255.0


def check_dir(path: str) -> str:
    os.makedirs(path, exist_ok=True)
    return path


def save_pickle(obj: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **arrays)


def extract_zip(zip_path: str, dest_dir: str) -> None:
    with zipfile.ZipFile(zip_path) as zf:
        zf.extractall(dest_dir)


def to_device_batch(batch: Any, device=None) -> Any:
    """Host batch -> tensors on ``device`` (the reference's
    ``tools.tensor_gpu``): every array or tensor of a dict, list or tuple
    (nested), on the card unless ``"cpu"`` is asked for."""
    from upflow_pytorch_tpu_torch.models.upflow import _resolve_device

    device = _resolve_device(device)

    def move(x):
        if isinstance(x, dict):
            return {k: move(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(move(v) for v in x)
        if not torch.is_tensor(x):
            x = np.asarray(x)
            x = torch.from_numpy(np.ascontiguousarray(x).reshape(x.shape))
        return x.to(device)

    return move(batch)
