"""Photometric losses, NCHW.

Port of ``upflow_pytorch_tpu.losses.photometric``: the reference's
``photo_loss_multi_type`` and its UFlow-derived ``weighted_ssim``.  The
masked ratio takes its denominator over the global batch inside the
sharded step (``parallel/reduce.py``).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.parallel.reduce import global_sum, rank_share


def _avg_pool3x3_valid(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 VALID average pool: the window sum divided by 9."""
    return F.avg_pool2d(x, 3, stride=1, padding=0)


def weighted_ssim(x: torch.Tensor, y: torch.Tensor, weight: torch.Tensor,
                  c1: float = float("inf"), c2: float = 9e-6,
                  weight_epsilon: float = 0.01
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted SSIM.  ``x``, ``y``: (B, C, H, W); ``weight``: (B, 1, H, W)
    in [0, 1].  Returns the loss map (B, C, H-2, W-2) and the pooled
    weight (B, 1, H-2, W-2)."""
    if c1 == float("inf") and c2 == float("inf"):
        raise ValueError("Both c1 and c2 are infinite, SSIM loss is zero.")
    average_pooled_weight = _avg_pool3x3_valid(weight)
    weight_plus_epsilon = weight + weight_epsilon
    inverse_average_pooled_weight = 1.0 / (average_pooled_weight
                                           + weight_epsilon)

    def weighted_avg_pool3x3(z):
        return (_avg_pool3x3_valid(z * weight_plus_epsilon)
                * inverse_average_pooled_weight)

    mu_x = weighted_avg_pool3x3(x)
    mu_y = weighted_avg_pool3x3(y)
    sigma_x = weighted_avg_pool3x3(x ** 2) - mu_x ** 2
    sigma_y = weighted_avg_pool3x3(y ** 2) - mu_y ** 2
    sigma_xy = weighted_avg_pool3x3(x * y) - mu_x * mu_y
    if c1 == float("inf"):
        ssim_n = 2 * sigma_xy + c2
        ssim_d = sigma_x + sigma_y + c2
    elif c2 == float("inf"):
        ssim_n = 2 * mu_x * mu_y + c1
        ssim_d = mu_x ** 2 + mu_y ** 2 + c1
    else:
        ssim_n = (2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)
        ssim_d = (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2)
    result = ssim_n / ssim_d
    return torch.clamp((1 - result) / 2, 0.0, 1.0), average_pooled_weight


def photo_loss_multi_type(x: torch.Tensor, y: torch.Tensor,
                          occ_mask: torch.Tensor,
                          photo_loss_type: str = "abs_robust",
                          photo_loss_delta: float = 0.4,
                          photo_loss_use_occ: bool = False) -> torch.Tensor:
    """Scalar photometric loss of ``x`` against ``y`` (B, C, H, W), with
    the visibility mask ``occ_mask`` (B, 1, H, W)."""
    occ_weight = occ_mask
    if photo_loss_type == "abs_robust":
        loss_diff = (torch.abs(x - y) + 0.01) ** photo_loss_delta
    elif photo_loss_type == "charbonnier":
        loss_diff = ((x - y) ** 2 + 1e-6) ** photo_loss_delta
    elif photo_loss_type == "L1":
        loss_diff = torch.abs(x - y + 1e-6)
    elif photo_loss_type == "SSIM":
        loss_diff, occ_weight = weighted_ssim(x, y, occ_mask)
    else:
        raise ValueError("wrong photo_loss type: %s" % photo_loss_type)
    if photo_loss_use_occ:
        return (rank_share((loss_diff * occ_weight).sum())
                / (global_sum(occ_weight.sum()) + 1e-6))
    return loss_diff.mean()
