"""Misc plumbing utilities.

Port of ``upflow_pytorch_tpu/utils/misc.py``, the reference's grab-bag
(``utils/tools.py:254-280,1634-1730``): the numpy and file helpers are
copies; ``resolve_device``, ``to_device_batch`` and the NHWC/NCHW
helpers put host data on the port's device.
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


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; None is the card (or raises)."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return torch.device("cuda" if device is None else device)


def host_tensor(x) -> torch.Tensor:
    """A tensor as it is, an array as a tensor on the host."""
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def as_nchw(x, device: torch.device) -> torch.Tensor:
    """NHWC images (a tensor or an array) as NCHW fp32 on ``device``."""
    return host_tensor(x).to(device=device, dtype=torch.float32).permute(
        0, 3, 1, 2).contiguous()


def to_device_batch(batch: Any, device=None) -> Any:
    """Host batch -> tensors on ``device`` (the reference's
    ``tools.tensor_gpu``): every array or tensor of a dict, list or tuple
    (nested), on the card unless ``"cpu"`` is asked for."""
    device = resolve_device(device)

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
