"""KITTI flow metrics.

Port of ``upflow_pytorch_tpu/eval/metrics.py``: exact re-derivations of
the reference's ``Evaluation_bench.flow_error_avg`` and ``outlier_pct``
(``dataset/kitti_dataset.py:463-499``), on HWC/NHWC numpy arrays on the
host (per image; KITTI's frame sizes vary).

Semantics to preserve exactly:
- EPE: sum(||pred-gt||_2 * mask) / (sum(mask) + 1e-6)
- F1:  100 * sum(masked_err > max(3, 0.05*||gt||)) / sum(mask)
  (the threshold map uses the UNMASKED gt magnitude; unmasked pixels have
  masked_err = 0 so they never count as outliers; no eps in the
  denominator, so an empty mask gives NaN)
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _euclidean(t: np.ndarray) -> np.ndarray:
    return np.sqrt(np.sum(t.astype(np.float64) ** 2, axis=-1, keepdims=True))


def flow_error_avg(gt_flow: np.ndarray, pred_flow: np.ndarray,
                   mask: np.ndarray) -> float:
    """Masked mean EPE. Arrays (..., H, W, 2) and mask (..., H, W, 1)."""
    diff = _euclidean(gt_flow - pred_flow) * mask
    return float(np.sum(diff) / (np.sum(mask) + 1e-6))


def outlier_pct(gt_flow: np.ndarray, pred_flow: np.ndarray, mask: np.ndarray,
                threshold: float = 3.0,
                relative: Optional[float] = 0.05) -> float:
    """KITTI F1-all outlier percentage."""
    diff = _euclidean(gt_flow - pred_flow) * mask
    if relative is not None:
        threshold_map = np.maximum(threshold, _euclidean(gt_flow) * relative)
        outliers = diff > threshold_map
    else:
        outliers = diff > threshold
    return float(np.sum(outliers) / np.sum(mask) * 100.0)
