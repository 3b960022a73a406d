"""Step-tagged training checkpoints, one ``torch.save`` file a step.

Port of ``upflow_pytorch_tpu/checkpoint/orbax_io.py``: a checkpoint holds
what a run needs to resume (the model's and the optimizer's state dicts,
the step and the loader's cursor: ``train/trainer.py::Trainer.save``), so
a run continues after a failure.  ``step_<n>.pt`` is written under a
temporary name and renamed into place, so a crash mid-write never leaves
a torn checkpoint that ``latest_step`` would pick; only the newest
``max_to_keep`` are kept.  Files are read back with
``torch.load(weights_only=True)``: tensors, containers and numbers only,
no code.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional

import torch

from upflow_pytorch_tpu_torch.utils.misc import resolve_device

_NAME = re.compile(r"step_(\d+)\.pt$")


def _path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, "step_%d.pt" % step)


def _steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(ckpt_dir)) if m)


def save_checkpoint(ckpt_dir: str, step: int, payload: Any,
                    max_to_keep: int = 3) -> None:
    """Writes ``payload`` as ``ckpt_dir/step_<step>.pt`` and deletes all but
    the newest ``max_to_keep`` checkpoints."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _path(ckpt_dir, step)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for old in _steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_path(ckpt_dir, old))


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest checkpoint's step, or None when there is none."""
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore_checkpoint(ckpt_dir: str, step: Optional[int] = None,
                       map_location=None) -> Any:
    """The payload of checkpoint ``step`` (the newest by default), its
    tensors on ``map_location`` (the card unless ``"cpu"`` is asked for);
    raises ``FileNotFoundError`` when there is none."""
    map_location = resolve_device(map_location)
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None or not os.path.exists(_path(ckpt_dir, step)):
        raise FileNotFoundError("no checkpoint%s found in %s" % (
            "" if step is None else " for step %d" % step, ckpt_dir))
    return torch.load(_path(ckpt_dir, step), map_location=map_location,
                      weights_only=True)
