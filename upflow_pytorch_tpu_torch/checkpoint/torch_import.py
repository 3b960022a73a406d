"""Import of the reference's ``.pth`` checkpoints.

Port of ``upflow_pytorch_tpu/checkpoint/torch_import.py``.  The JAX
package parses ``.pth`` files without torch; here ``torch.load(...,
weights_only=True)`` reads both formats, the zip layout (torch >= 1.6) and
the legacy stream that torch 1.1 wrote for the reference's
``upflow_kitti2015.pth``, storage views included, and refuses any global
that is not a tensor, a storage or a container.  The ancient (~torch 0.1)
tar container is rejected, as the JAX reader rejects it.

The port's module names are the reference's state-dict keys
(``checkpoint/convert.py``), so the merge copies each tensor into the
parameter of the same name, with the reference's relaxed semantics: keys
the model lacks and shape mismatches are skipped (or, strict, raise).
"""

from __future__ import annotations

import tarfile
from typing import Dict, List

import torch
import torch.nn as nn

from upflow_pytorch_tpu_torch.checkpoint.convert import (
    flax_path_for_torch_key)


def _is_legacy_tar(path: str) -> bool:
    try:
        with tarfile.open(path, mode="r:") as tar:
            names = tar.getnames()
        return "pickle" in names and "storages" in names
    except (tarfile.TarError, OSError, EOFError):
        return False


def load_torch_state_dict(path: str):
    """A torch-saved state dict (zip or legacy format) as CPU tensors;
    the ~torch 0.1 tar container raises ``NotImplementedError``."""
    if _is_legacy_tar(path):
        raise NotImplementedError(
            "torch tar-container checkpoints (~torch 0.1) are not supported:"
            " %s" % path)
    return torch.load(path, map_location="cpu", weights_only=True)


def _mapped(key: str) -> bool:
    """Whether the JAX package maps ``key`` onto a parameter leaf: a
    weight or bias of one of the reference's modules (a key under another
    module is skipped, strict or not)."""
    prefix, _, leaf = key.rpartition(".")
    return (leaf in ("weight", "bias")
            and flax_path_for_torch_key(prefix) is not None)


@torch.no_grad()
def torch_state_dict_to_params(state_dict: Dict[str, torch.Tensor],
                               model: nn.Module, relaxed: bool = True,
                               verbose: bool = False
                               ) -> Dict[str, List[str]]:
    """Copies a reference state dict into ``model``'s parameters in place.

    ``relaxed`` is the reference's ``load_model(if_relax=True)``: keys the
    model lacks and shape mismatches are skipped; strict, they raise
    ``KeyError`` and ``ValueError``.  Keys outside the reference's modules
    are skipped either way.  Returns the report ``{"loaded": [...],
    "skipped": [...]}`` in the dict's order."""
    params = dict(model.named_parameters())
    loaded, skipped = [], []
    for key, value in state_dict.items():
        if not _mapped(key):
            skipped.append(key)
            continue
        value = torch.as_tensor(value)
        if key not in params:
            if not relaxed:
                raise KeyError("no target param for %s" % key)
            skipped.append(key)
            continue
        if params[key].shape != value.shape:
            if not relaxed:
                raise ValueError("shape mismatch for %s: %s vs %s"
                                 % (key, tuple(params[key].shape),
                                    tuple(value.shape)))
            skipped.append(key)
            continue
        params[key].copy_(value)
        loaded.append(key)
    if verbose:
        print("loaded %d keys, skipped %d: %s"
              % (len(loaded), len(skipped), skipped[:10]))
    return {"loaded": loaded, "skipped": skipped}


def load_pretrained_params(path: str, model: nn.Module, relaxed: bool = True,
                           verbose: bool = False) -> Dict[str, List[str]]:
    """Reads the ``.pth`` file and merges it into ``model``."""
    return torch_state_dict_to_params(load_torch_state_dict(path), model,
                                      relaxed, verbose)


def params_to_torch_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters under the reference's keys, as CPU tensors
    (what ``torch.save`` writes for the reference side)."""
    return {k: p.detach().cpu().clone() for k, p in model.named_parameters()}
