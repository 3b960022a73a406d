"""The fine-tune recipe's unsupervised loss in plain fp32 PyTorch, NCHW.

UPFlow's ``forward`` with ``if_loss``: edge-aware first-order smoothness
of the final flows, the robust photometric loss (``(|d| + 0.01) ** 0.4``)
and the census loss of both frames against the other frame's uncropped
image warped onto the crop by the boundary-dilated warp, and the
multi-scale distillation ('upup': each decode level's flow resized to the
final size against the final flow, detached, on visible pixels), with the
recipe's weights.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference import upflow

DELTA = 0.4


def boundary_warp(img: torch.Tensor, flow: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """``warp_im``: samples the uncropped image (B, C, Hf, Wf) at ``start
    + p + flow(p)`` for the crop's pixels ``p``, the corners clamped to
    the image and the weights taken from the clamped corners."""
    b, c, ih, iw = img.shape
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    px = xs[None, None, :] + flow[:, 0] + start[:, 0, None, None]
    py = ys[None, :, None] + flow[:, 1] + start[:, 1, None, None]
    fx, fy = torch.floor(px), torch.floor(py)
    x0, x1 = fx.clamp(0, iw - 1), (fx + 1.0).clamp(0, iw - 1)
    y0, y1 = fy.clamp(0, ih - 1), (fy + 1.0).clamp(0, ih - 1)
    flat = img.reshape(b, c, ih * iw)

    def tap(yc, xc):
        idx = (yc * iw + xc).long().reshape(b, 1, h * w).expand(b, c, h * w)
        return torch.gather(flat, 2, idx).reshape(b, c, h, w)

    wa = ((x1 - px) * (y1 - py))[:, None]
    wb = ((x1 - px) * (py - y0))[:, None]
    wc = ((px - x0) * (y1 - py))[:, None]
    wd = ((px - x0) * (py - y0))[:, None]
    return (wa * tap(y0, x0) + wb * tap(y1, x0) + wc * tap(y0, x1)
            + wd * tap(y1, x1))


def smoothness(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Edge-aware first-order smoothness."""
    def gh(x):
        return x[:, :, :-1, :] - x[:, :, 1:, :]

    def gw(x):
        return x[:, :, :, :-1] - x[:, :, :, 1:]

    wh = torch.exp(-gh(img).abs().mean(dim=1, keepdim=True))
    ww = torch.exp(-gw(img).abs().mean(dim=1, keepdim=True))
    return (gh(flow).abs() * wh).mean() + (gw(flow).abs() * ww).mean()


def census(img: torch.Tensor, warped: torch.Tensor) -> torch.Tensor:
    """The soft census loss over 7x7 neighbourhoods, unmasked."""
    def transform(x):
        gray = 0.2989 * x[:, 0:1] + 0.5870 * x[:, 1:2] + 0.1140 * x[:, 2:3]
        _, _, h, w = gray.shape
        pad = F.pad(gray, (3, 3, 3, 3))
        t = torch.cat([pad[:, :, dy:dy + h, dx:dx + w]
                       for dy in range(7) for dx in range(7)], dim=1) - gray
        return t / torch.sqrt(0.81 + t ** 2)

    d = (transform(img) - transform(warped)) ** 2
    dist = (d / (0.1 + d)).sum(dim=1, keepdim=True)
    return ((dist.abs() + 0.01) ** DELTA).mean()


def robust(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return ((x - y).abs() + 0.01) ** DELTA


def loss_terms(p: upflow.Params, batch: Dict[str, torch.Tensor],
               census_weight: float, msd_weight: float,
               num: upflow.Numerics = upflow.Numerics()
               ) -> Dict[str, torch.Tensor]:
    """The loss terms and ``total_loss`` for an NHWC batch (``im1``,
    ``im2``, ``im1_raw``, ``im2_raw``, ``start``)."""
    def nchw(k):
        return batch[k].permute(0, 3, 1, 2).contiguous()

    im1, im2 = nchw("im1"), nchw("im2")
    flow_f, flow_b, flows = upflow.network(p, im1, im2, num)
    with torch.no_grad():
        occ_f, occ_b = upflow.occlusion(flow_f, flow_b)
    start = batch["start"]
    im1_warp = boundary_warp(nchw("im2_raw"), flow_f, start)
    im2_warp = boundary_warp(nchw("im1_raw"), flow_b, start)
    smooth = smoothness(im1, flow_f) + smoothness(im2, flow_b)
    photo = robust(im1, im1_warp).mean() + robust(im2, im2_warp).mean()
    cen = census_weight * (census(im1, im1_warp) + census(im2, im2_warp))
    hw = tuple(flow_f.shape[2:])
    msd = flow_f.new_zeros(())
    for scale_f, scale_b in flows:
        for pred, label, occ in (
                (upflow.upsample_flow(scale_f, hw), flow_f.detach(), occ_f),
                (upflow.upsample_flow(scale_b, hw), flow_b.detach(), occ_b)):
            msd = msd + ((robust(pred, label) * occ).sum()
                         / (occ.sum() + 1e-6))
    msd = msd_weight * msd
    return {"photo_loss": photo, "smooth_loss": smooth, "census_loss": cen,
            "msd_loss": msd, "total_loss": photo + smooth + cen + msd}
