"""Census loss, NCHW.

Port of ``upflow_pytorch_tpu.losses.census``: the reference's
``census_loss_torch`` and ``photo_loss_function``.  The masked ratios
take their denominators over the global batch inside the sharded step
(``parallel/reduce.py``).
"""

from __future__ import annotations

import torch

from upflow_pytorch_tpu_torch.ops.census import (
    census_border_mask, census_hamming_distance, ternary_transform)
from upflow_pytorch_tpu_torch.parallel.reduce import (
    global_mean, global_sum, rank_share)


def photo_loss_function(diff: torch.Tensor, mask: torch.Tensor, q: float,
                        charbonnier_or_abs_robust: bool, if_use_occ: bool,
                        average: bool = True) -> torch.Tensor:
    """The reference's ``photo_loss_function``, with its asymmetric eps
    and denominators kept."""
    if charbonnier_or_abs_robust:
        if if_use_occ:
            p = (diff ** 2 + 1e-6) ** q * mask
            if average:
                return p.mean() / (global_mean(mask.mean()) * 2 + 1e-6)
            return rank_share(p.sum()) / (global_sum(mask.sum()) * 2 + 1e-6)
        p = (diff ** 2 + 1e-8) ** q
        return p.mean() if average else rank_share(p.sum())
    if if_use_occ:
        d = (torch.abs(diff) + 0.01) ** q * mask
        return rank_share(d.sum()) / (global_sum(mask.sum()) * 2 + 1e-6)
    d = (torch.abs(diff) + 0.01) ** q
    return d.mean() if average else rank_share(d.sum())


def census_loss(img1: torch.Tensor, img1_warp: torch.Tensor,
                mask: torch.Tensor, q: float = 0.4,
                charbonnier_or_abs_robust: bool = False,
                if_use_occ: bool = False, average: bool = True,
                max_distance: int = 3) -> torch.Tensor:
    """Scalar census loss of an image (B, 3, H, W) against its warp, with
    the visibility mask (B, 1, H, W)."""
    t1 = ternary_transform(img1, max_distance)
    t2 = ternary_transform(img1_warp, max_distance)
    dist = census_hamming_distance(t1, t2)
    transform_mask = census_border_mask(mask.shape, max_distance,
                                        mask.dtype, mask.device)
    return photo_loss_function(dist, mask * transform_mask, q,
                               charbonnier_or_abs_robust, if_use_occ,
                               average)
