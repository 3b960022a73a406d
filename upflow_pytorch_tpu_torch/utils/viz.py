"""Flow visualization: Middlebury color wheel + KITTI-style error maps.

Copy of ``upflow_pytorch_tpu/utils/viz.py`` (numpy): functional
equivalents of the reference's ``tools.flow_to_image``
(``utils/tools.py:1341-1480``) and ``tools.lib_to_show_flow.
flow_error_image_np`` (:679-758), vectorized.
"""

from __future__ import annotations

import numpy as np

_UNKNOWN_FLOW_THRESH = 1e7


def make_color_wheel() -> np.ndarray:
    """55-color Middlebury wheel, rows RGB in [0, 255]."""
    transitions = [  # (count, from_channel, to_channel)
        (15, 0, 1),  # RY
        (6, 1, 0),   # YG (red falls)
        (4, 1, 2),   # GC
        (11, 2, 1),  # CB (green falls)
        (13, 2, 0),  # BM
        (6, 0, 2),   # MR (blue falls)
    ]
    rows = []
    active = {0}
    for count, base, ramp in transitions:
        seg = np.zeros((count, 3))
        seg[:, base] = 255
        r = np.floor(255 * np.arange(count) / count)
        if (count, base, ramp) in ((6, 1, 0), (11, 2, 1), (6, 0, 2)):
            seg[:, ramp] = 255 - r  # falling edge
        else:
            seg[:, ramp] = r  # rising edge
        rows.append(seg)
    return np.concatenate(rows, axis=0)


_WHEEL = None


def flow_to_image(flow: np.ndarray, max_rad: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury colorization."""
    global _WHEEL
    if _WHEEL is None:
        _WHEEL = make_color_wheel()
    u = flow[..., 0].astype(np.float64).copy()
    v = flow[..., 1].astype(np.float64).copy()
    unknown = (np.abs(u) > _UNKNOWN_FLOW_THRESH) | (np.abs(v) > _UNKNOWN_FLOW_THRESH)
    u[unknown] = 0
    v[unknown] = 0
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_rad is None:
        max_rad = max(-1.0, rad.max())
    eps = np.finfo(float).eps
    u = u / (max_rad + eps)
    v = v / (max_rad + eps)

    wheel = _WHEEL
    ncols = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = (fk - np.floor(fk))[..., None]
    col = (1 - f) * wheel[k0] / 255.0 + f * wheel[k1] / 255.0
    small = rad <= 1
    col = np.where(small[..., None], 1 - rad[..., None] * (1 - col), col * 0.75)
    col[unknown] = 0
    return np.floor(255 * col).astype(np.uint8)


def flow_error_image(gt_flow: np.ndarray, pred_flow: np.ndarray,
                     mask: np.ndarray) -> np.ndarray:
    """KITTI-devkit-style log-binned error colormap.

    gt/pred (H, W, 2), mask (H, W) or (H, W, 1) -> (H, W, 3) uint8.
    """
    # (log2 error bin upper bounds, RGB) after the KITTI devkit palette
    bins = np.array([0.1875, 0.375, 0.75, 1.5, 3, 6, 12, 24, 48, np.inf])
    colors = np.array([
        [49, 54, 149], [69, 117, 180], [116, 173, 209], [171, 217, 233],
        [224, 243, 248], [254, 224, 144], [253, 174, 97], [244, 109, 67],
        [215, 48, 39], [165, 0, 38]], dtype=np.float64)
    mask2 = np.asarray(mask).reshape(mask.shape[0], mask.shape[1])
    err = np.sqrt(np.sum((gt_flow - pred_flow) ** 2, axis=-1))
    mag = np.sqrt(np.sum(gt_flow ** 2, axis=-1))
    ratio = np.minimum(err / 3.0, 20 * err / np.maximum(mag, 1e-9))
    idx = np.digitize(ratio, bins)
    img = colors[np.clip(idx, 0, len(colors) - 1)]
    img[mask2 == 0] = 0
    return img.astype(np.uint8)


def overlay_arrows(img: np.ndarray, flow: np.ndarray, stride: int = 16
                   ) -> np.ndarray:
    """Sparse arrow overlay (``point_vec``-style, tools.py:690-714).

    Requires cv2; returns the image unchanged if unavailable.
    """
    try:
        import cv2
    except ImportError:
        return img
    out = np.ascontiguousarray(img.copy())
    h, w = flow.shape[:2]
    for y in range(0, h, stride):
        for x in range(0, w, stride):
            u, v = flow[y, x]
            cv2.arrowedLine(out, (x, y), (int(x + u), int(y + v)),
                            (0, 255, 0), 1, tipLength=0.3)
    return out
