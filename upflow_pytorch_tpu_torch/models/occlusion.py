"""Analytic occlusion estimation via forward-backward consistency (NCHW).

``tools.occ_check_model`` of the reference.  Mask convention: 0 =
occluded, 1 = visible.  The length function is the sum of per-channel
``sqrt(x^2)``, as the reference hard-forces ``sum_abs_or_squar``.  The two
flow warps go through the image-warp kernel (``ops/kernels/warp.py``).
"""

from __future__ import annotations

import torch

from upflow_pytorch_tpu_torch.ops.warp import flow_warp


def _length_sum_abs(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x ** 2).sum(dim=1, keepdim=True)


def _forward_backward_check(flow_fw, flow_bw, alpha_1, alpha_2, scale=1.0):
    mag = _length_sum_abs(flow_fw) + _length_sum_abs(flow_bw)
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    flow_fw_warped = flow_warp(flow_fw, flow_bw)
    diff_fw = flow_fw + flow_bw_warped
    diff_bw = flow_bw + flow_fw_warped
    thresh = alpha_1 * mag + alpha_2 / scale
    occ_fw = (_length_sum_abs(diff_fw) < thresh).float()
    occ_bw = (_length_sum_abs(diff_bw) < thresh).float()
    return occ_fw, occ_bw


def _outgoing_check(flow: torch.Tensor) -> torch.Tensor:
    """1 where the flow target stays inside the frame."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    pos_x = xs[None, None, :] + flow[:, 0]
    pos_y = ys[None, :, None] + flow[:, 1]
    inside = (pos_x <= w - 1) & (pos_x >= 0) & (pos_y <= h - 1) & (pos_y >= 0)
    return inside.float()[:, None]


def occ_check(flow_fw: torch.Tensor, flow_bw: torch.Tensor,
              alpha_1: float = 0.1, alpha_2: float = 0.5,
              obj_out_all: str = "obj", occ_type: str = "for_back_check",
              scale: float = 1.0):
    """(B, 2, H, W) flows -> (occ_fw, occ_bw) visibility masks
    (B, 1, H, W) in {0, 1}."""
    if occ_type != "for_back_check":
        raise ValueError("only 'for_back_check' is implemented (as in the "
                         "reference; 'forward_warp' raises there too)")
    if obj_out_all == "out":
        return _outgoing_check(flow_fw), _outgoing_check(flow_bw)
    occ_fw, occ_bw = _forward_backward_check(flow_fw, flow_bw,
                                             alpha_1, alpha_2, scale)
    if obj_out_all == "all":
        return occ_fw, occ_bw
    if obj_out_all == "obj":
        # pixels flowing OUT of the frame are forced visible (mask=1)
        obj_fw = ((occ_fw == 1) | (_outgoing_check(flow_fw) == 0)).float()
        obj_bw = ((occ_bw == 1) | (_outgoing_check(flow_bw) == 0)).float()
        return obj_fw, obj_bw
    raise ValueError("obj_out_all must be 'obj', 'out' or 'all'")
