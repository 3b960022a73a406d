"""Flax parameter paths -> the port's state-dict keys.

The port's module names follow the reference torch state-dict keys
(``feature_pyramid_extractor.convs.L.j.0``, ``flow_estimators.convN.0``,
``context_networks.convs.i.0``, ``conv_1x1.i.0``), so the mapping is the
reference key map plus HWIO -> OIHW kernels.
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
