"""Feature normalisation before the cost volume (NCHW).

``network_tools.normalize_features`` with its quirks:

- variances are UNBIASED (torch.var default, ddof=1);
- with ``moments_across_images`` the cross-image statistics are the MEAN
  of the per-image means but the (unbiased) VARIANCE OF the per-image
  variances;
- std = sqrt(var + 1e-16).

Per-image moments reduce over (H, W) and optionally C.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _var_unbiased(x: torch.Tensor, dims, keepdim: bool = True) -> torch.Tensor:
    n = 1
    for d in dims:
        n *= x.shape[d]
    mean = x.mean(dim=dims, keepdim=True)
    return ((x - mean) ** 2).sum(dim=dims, keepdim=keepdim) / max(n - 1, 1)


def normalize_features(
    feature_list: Sequence[torch.Tensor],
    normalize: bool = True,
    center: bool = True,
    moments_across_channels: bool = True,
    moments_across_images: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """Normalise a list of NCHW feature maps (typically the (f1, f2) pair)."""
    dims = (1, 2, 3) if moments_across_channels else (2, 3)
    means = [f.float().mean(dim=dims, keepdim=True) for f in feature_list]
    variances = [_var_unbiased(f.float(), dims) for f in feature_list]

    if moments_across_images:
        mean_all = torch.stack(means, 0).mean(dim=0)
        # the reference takes torch.var over the stacked per-image variances
        var_all = _var_unbiased(torch.stack(variances, 0), (0,),
                                keepdim=False)
        means = [mean_all] * len(feature_list)
        variances = [var_all] * len(feature_list)

    stds = [torch.sqrt(v + 1e-16) for v in variances]
    out = list(feature_list)
    if center:
        out = [f - m for f, m in zip(out, means)]
    if normalize:
        out = [f / s for f, s in zip(out, stds)]
    return tuple(o.to(f.dtype) for o, f in zip(out, feature_list))
