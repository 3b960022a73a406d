"""Flax parameter paths <-> the port's state-dict keys.

The port's module names follow the reference torch state-dict keys
(``feature_pyramid_extractor.convs.L.j.0``, ``flow_estimators.convN.0``,
``context_networks.convs.i.0``, ``conv_1x1.i.0``), so the mapping is the
reference key map plus HWIO <-> OIHW kernels.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch


def torch_key_for_flax_path(path: Tuple[str, ...]) -> Optional[str]:
    """Module prefix for a flax module path (without 'params' and the
    kernel/bias leaf); None for paths the reference has no key for."""
    if not path:
        return None
    root = path[0]
    if root == "feature_pyramid_extractor":
        name = path[1]  # level{L}_conv{J}
        return "feature_pyramid_extractor.convs.%d.%d.0" % (int(name[5]),
                                                           int(name[-1]))
    if root == "flow_estimators":
        return "flow_estimators.%s.0" % path[1]
    if root == "context_networks":
        return "context_networks.convs.%d.0" % int(path[1][4:])
    if root.startswith("conv_1x1_"):
        return "conv_1x1.%d.0" % int(root[len("conv_1x1_"):])
    if root == "sgu_dense_estimator":
        return "sgi_model.dense_estimator_mask.%s.0" % path[2]
    if root == "sgu_output_conv":
        return "sgi_model.upsample_output_conv.%d.0" % int(path[1][4:])
    return None


def flax_path_for_torch_key(key: str) -> Optional[Tuple[str, ...]]:
    """The flax module path of a reference module prefix (the inverse of
    ``torch_key_for_flax_path``); None for a prefix it does not map."""
    parts = key.split(".")
    if len(parts) < 3:
        return None
    if parts[0] == "feature_pyramid_extractor" and len(parts) > 3:
        return ("feature_pyramid_extractor",
                "level%s_conv%s" % (parts[2], parts[3]), "conv")
    if parts[0] == "flow_estimators":
        return ("flow_estimators", parts[1], "conv")
    if parts[0] == "context_networks":
        return ("context_networks", "conv" + parts[2], "conv")
    if parts[0] == "conv_1x1":
        return ("conv_1x1_" + parts[1], "conv")
    if parts[:2] == ["sgi_model", "dense_estimator_mask"]:
        return ("sgu_dense_estimator", "dense", parts[2], "conv")
    if parts[:2] == ["sgi_model", "upsample_output_conv"]:
        return ("sgu_output_conv", "conv" + parts[2], "conv")
    return None


def torch_to_flax_flat(state_dict: Dict[str, torch.Tensor]
                       ) -> Dict[str, np.ndarray]:
    """Reference torch keys -> '/'-joined flax leaves under ``params/``
    (the layout of ``load_npz_flat``), kernels in HWIO; raises
    ``KeyError`` for a key it does not map."""
    out: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        prefix, leaf = key.rsplit(".", 1)
        path = flax_path_for_torch_key(prefix)
        if path is None or leaf not in ("weight", "bias"):
            raise KeyError("no flax path for %s" % key)
        value = value.detach().cpu().numpy()
        if leaf == "weight":
            out["/".join(("params",) + path + ("kernel",))] = \
                value.transpose(2, 3, 1, 0)
        else:
            out["/".join(("params",) + path + ("bias",))] = value
    return out


def flax_flat_to_torch(flat: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """'/'-joined flax leaves -> reference torch keys, kernels in OIHW."""
    out: Dict[str, np.ndarray] = {}
    for name, value in flat.items():
        leaf = tuple(name.split("/"))
        if leaf[0] == "params":
            leaf = leaf[1:]
        key = torch_key_for_flax_path(leaf[:-1])
        if key is None:
            continue
        value = np.asarray(value)
        if leaf[-1] == "kernel":
            out[key + ".weight"] = value.transpose(3, 2, 0, 1)
        elif leaf[-1] == "bias":
            out[key + ".bias"] = value
    return out


def params_from_jax(flat: Dict[str, np.ndarray],
                    model_keys: Optional[Iterable[str]] = None,
                    skipped: Optional[List[str]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Flax snapshot (``load_npz_flat``) -> a state dict for the port.

    With ``model_keys`` (``model.state_dict().keys()``) the result holds
    exactly those keys: entries the model lacks (the ``sgu_*`` weights of
    a model built without SGU) are dropped and appended to ``skipped``,
    and a model key the snapshot lacks raises ``KeyError``.
    """
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in flax_flat_to_torch(flat).items()}
    if model_keys is None:
        return sd
    wanted = list(model_keys)
    missing = [k for k in wanted if k not in sd]
    if missing:
        raise KeyError("snapshot lacks model keys: %s" % missing)
    if skipped is not None:
        keep = set(wanted)
        skipped.extend(sorted(k for k in sd if k not in keep))
    return {k: sd[k] for k in wanted}
