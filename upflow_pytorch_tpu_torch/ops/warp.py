"""Backward warping (grid sample) ops, NCHW.

Three warp semantics of the reference:

1. ``flow_warp`` — ``tools.torch_warp``: bilinear sample at ``(x+u, y+v)``
   with zeros outside the image, no validity mask.  Used by the occlusion
   check, and by ``sgu_blend`` / ``sgu_blend_pair``, the SGU's blend of a
   flow with its warp.
2. ``flow_warp_with_mask`` / ``flow_warp_masked`` — ``WarpingLayer_no_div``:
   the same sample times ``mask = (warped all-ones >= threshold)``.
3. ``boundary_dilated_warp`` — ``tools.boundary_dilated_warp.warp_im``:
   the photometric loss's warp of the uncropped frame, edges replicated.

The first two reproduce the reference's torch ``grid_sample`` arithmetic
exactly: the fp32 normalise -> unnormalise coordinate roundtrip
(``_torch_grid_roundtrip``), the ``(x0+1)-px`` weights and the analytic
warped-ones sum (``_analytic_wsum``).  The ``>= 1.0`` mask is chaotic in
the last fp32 ulp of the flow, so every step here is a single IEEE
operation in a fixed order: no fused multiply-add and no reciprocal
multiply in place of a division.  The CUDA kernels
(``ops/kernels/feature_warp.py``, ``warp.py``, ``sgu_blend.py`` and
``sgu_final.py``) do the same operations in the same order with
``__f*_rn`` intrinsics.

``bilinear_sample_vjp``, ``flow_vjp`` and ``warp_vjp`` are the JAX
package's gradient rule of the sample (scatter-adds for the image, four
taps for the coordinates), for the kernels' backward rules.

Tensors: images ``(B, C, H, W)``, flows ``(B, 2, H, W)`` with channels
``(u, v)``, coordinate planes ``(B, H, W)``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

# Validity-mask threshold for the masked warp.  The reference's
# WarpingLayer_no_div uses ``warped_ones >= 1.0``, which is CHAOTIC at
# interior pixels: the fp32 4-product weight sum rounds to 1.0 or 1.0-1ulp
# depending on the last bit of the flow, pseudo-randomly zeroing ~1-2% of
# interior warped features.  It is reproduced faithfully by default (the
# checkpoint was trained with it); tests that compare full models across
# frameworks set this to 0.9999 — the threshold the reference itself uses
# in tools.torch_warp_mask — because the chaotic bit can never agree
# between two different conv stacks.
MASK_THRESHOLD = 1.0


def mask_threshold() -> float:
    """Warp-mask threshold.

    Default: the reference-faithful chaotic ``MASK_THRESHOLD`` (1.0).
    ``UPFLOW_ROBUST_MASK=1`` backs it off 3 fp32 ulps so pixels with full
    in-bounds bilinear support are deterministically valid, and the model
    stops amplifying 1-ulp numeric differences into visible flow deltas.
    """
    if os.environ.get("UPFLOW_ROBUST_MASK"):
        return 1.0 - 3.0 * 2.0 ** -23
    return MASK_THRESHOLD


def _true_div(a: torch.Tensor, d: float) -> torch.Tensor:
    """IEEE ``a / d``.  The divisor is a tensor on ``a``'s device: PyTorch's
    CUDA division by a Python scalar multiplies by the reciprocal, which
    is not the correctly rounded quotient."""
    return a / torch.full((), d, dtype=a.dtype, device=a.device)


def _torch_grid_roundtrip(p: torch.Tensor, size: int) -> torch.Tensor:
    """torch grid_sample's fp32 normalise -> unnormalise roundtrip.

    The reference normalises absolute coords with ``2*v/max(S-1,1) - 1``
    and grid_sample (align_corners=True) unnormalises with
    ``((g+1)/2)*(S-1)``.  In fp32 this perturbs coordinates by ~1 ulp —
    enough to flip the ``>= 1.0`` mask — so it is reproduced op for op.
    """
    p = p.float()
    norm = _true_div(2.0 * p, float(max(size - 1, 1))) - 1.0
    return (norm + 1.0) / 2.0 * float(size - 1)


def abs_coords_torch_grid(flow: torch.Tensor, x0: int = 0,
                          width: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute sample coords ``(px, py)``, each (B, H, w), passed through
    the grid_sample roundtrip.  The flow's w columns are the columns
    ``[x0, x0 + w)`` of a frame ``width`` columns wide (by default the
    flow's own): the global column is an integer before it becomes a
    float, and the roundtrip divides by the frame's width."""
    _, _, h, w = flow.shape
    xs = torch.arange(x0, x0 + w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    px = xs[None, None, :] + flow[:, 0].float()
    py = ys[None, :, None] + flow[:, 1].float()
    return (_torch_grid_roundtrip(px, w if width is None else width),
            _torch_grid_roundtrip(py, h))


def _tap_weights(px: torch.Tensor, py: torch.Tensor):
    """Corner coords and torch grid_sampler weights: ``(x0+1)-px``, NOT
    ``1-(px-x0)`` — they differ by 1 ulp near integer coords, which
    decides the ``>= 1.0`` mask."""
    x0 = torch.floor(px)
    y0 = torch.floor(py)
    wx1 = px - x0
    wx0 = (x0 + 1.0) - px
    wy1 = py - y0
    wy0 = (y0 + 1.0) - py
    return x0, y0, wx0, wx1, wy0, wy1


def _analytic_wsum(ih: int, iw: int, px: torch.Tensor,
                   py: torch.Tensor) -> torch.Tensor:
    """Warp of an all-ones image: the in-bounds bilinear weight sum."""
    x0, y0, wx0, wx1, wy0, wy1 = _tap_weights(px, py)

    def inb(yc, xc):
        return ((xc >= 0) & (xc <= iw - 1) & (yc >= 0) & (yc <= ih - 1)
                ).float()

    return (wy0 * wx0 * inb(y0, x0) + wy0 * wx1 * inb(y0, x0 + 1)
            + wy1 * wx0 * inb(y0 + 1, x0) + wy1 * wx1 * inb(y0 + 1, x0 + 1))


def _gather_taps(x: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor,
                 mode: str = "constant"):
    """The 2x2 taps ``(p00, p01, p10, p11)`` at corners (y0, x0) .. (y0+1,
    x0+1) of ``x`` (B, C, Hi, Wi), each (B, C, H, W) fp32, read from a
    2-pixel border (zeros, or with ``mode="replicate"`` the edge pixels),
    so every corner outside the image reads the border."""
    b, c, ih, iw = x.shape
    _, h, w = x0.shape
    xp = torch.nn.functional.pad(x.float(), (2, 2, 2, 2), mode=mode)
    wp = iw + 4
    sy = (torch.clamp(y0, -2, ih) + 2).long()
    sx = (torch.clamp(x0, -2, iw) + 2).long()
    flat = xp.reshape(b, c, -1)

    def tap(dy, dx):
        idx = ((sy + dy) * wp + (sx + dx)).reshape(b, 1, h * w)
        return torch.gather(flat, 2, idx.expand(b, c, h * w)
                            ).reshape(b, c, h, w)

    return tap(0, 0), tap(0, 1), tap(1, 0), tap(1, 1)


def bilinear_sample(x: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sample of ``x`` (B, C, Hi, Wi) at absolute
    coords (B, H, W).  Taps are read from a 2-pixel zero border, so every
    out-of-image tap reads 0; the sum is ``p00*w00 + p01*w01 + p10*w10 +
    p11*w11``, left to right."""
    x0, y0, wx0, wx1, wy0, wy1 = _tap_weights(px, py)
    p00, p01, p10, p11 = _gather_taps(x, x0, y0)
    w00 = (wy0 * wx0)[:, None]
    w01 = (wy0 * wx1)[:, None]
    w10 = (wy1 * wx0)[:, None]
    w11 = (wy1 * wx1)[:, None]
    return p00 * w00 + p01 * w01 + p10 * w10 + p11 * w11


def bilinear_sample_vjp(x: torch.Tensor, px: torch.Tensor,
                        py: torch.Tensor, g: torch.Tensor):
    """The gradient of ``bilinear_sample(x, px, py)`` given the cotangent
    ``g`` (B, C, H, W) of its output, as the JAX package's hand-written
    rule (``ops/warp.py::_bilinear_sample_bwd``) computes it: ``d_x`` by
    scatter-adding each tap's weighted cotangent into its in-image corner
    (in ``x``'s type), and the coordinates' ``d_px``, ``d_py`` (B, H, W)
    from the four taps' differences."""
    b, c, ih, iw = x.shape
    _, h, w = px.shape
    g = g.float()
    x0, y0, wx0, wx1, wy0, wy1 = _tap_weights(px, py)
    idx, vals = [], []
    for yc, xc, wt in ((y0, x0, wy0 * wx0), (y0, x0 + 1, wy0 * wx1),
                       (y0 + 1, x0, wy1 * wx0), (y0 + 1, x0 + 1, wy1 * wx1)):
        valid = (xc >= 0) & (xc <= iw - 1) & (yc >= 0) & (yc <= ih - 1)
        idx.append((torch.clamp(yc, 0, ih - 1) * iw
                    + torch.clamp(xc, 0, iw - 1)).long().reshape(b, 1, -1))
        vals.append((wt * valid).reshape(b, 1, -1))
    gf = g.reshape(b, c, 1, h * w)
    d_x = g.new_zeros((b, c, ih * iw)).scatter_add_(
        2, torch.cat(idx, 2).expand(b, c, 4 * h * w),
        (gf * torch.stack(vals, 2)).reshape(b, c, 4 * h * w))
    p00, p01, p10, p11 = _gather_taps(x, x0, y0)
    d_px = (g * (wy0[:, None] * (p01 - p00)
                 + wy1[:, None] * (p11 - p10))).sum(dim=1)
    d_py = (g * (wx0[:, None] * (p10 - p00)
                 + wx1[:, None] * (p11 - p01))).sum(dim=1)
    return d_x.reshape(b, c, ih, iw).to(x.dtype), d_px, d_py


def _grid_roundtrip_vjp(g: torch.Tensor, size: int) -> torch.Tensor:
    """The gradient of ``_torch_grid_roundtrip`` as JAX's autodiff chains
    it: ``g * (S-1) / 2``, then ``/ max(S-1, 1) * 2`` (0 where S = 1)."""
    return g * float(size - 1) / 2.0 / float(max(size - 1, 1)) * 2.0


def flow_vjp(d_px: torch.Tensor, d_py: torch.Tensor) -> torch.Tensor:
    """The gradient of ``abs_coords_torch_grid(flow)`` with respect to the
    (B, 2, H, W) flow, given the coordinates' cotangents (B, H, W)."""
    _, h, w = d_px.shape
    return torch.stack([_grid_roundtrip_vjp(d_px, w),
                        _grid_roundtrip_vjp(d_py, h)], dim=1)


def warp_vjp(x: torch.Tensor, flow: torch.Tensor, g: torch.Tensor):
    """(d_x, d_flow) of the unmasked warp ``bilinear_sample(x,
    abs_coords_torch_grid(flow))`` given its output's cotangent ``g``."""
    px, py = abs_coords_torch_grid(flow)
    d_x, d_px, d_py = bilinear_sample_vjp(x, px, py, g)
    return d_x, flow_vjp(d_px, d_py)


def sgu_blend_vjp(flow: torch.Tensor, inter_flow: torch.Tensor,
                  mask: torch.Tensor, g: torch.Tensor):
    """(d_flow, d_inter_flow, d_mask) of the SGU blend ``warp(flow,
    inter_flow) * (1 - mask) + flow * mask`` (``_sgu_blend_xla``) given
    its output's cotangent ``g``; flows (B, 2, H, W), mask (B, 1, H, W).
    The warp is recomputed from the saved inputs."""
    g = g.float()
    px, py = abs_coords_torch_grid(inter_flow)
    warped = bilinear_sample(flow, px, py)
    d_warped, d_px, d_py = bilinear_sample_vjp(flow, px, py, g * (1 - mask))
    d_mask = (g * (flow.float() - warped)).sum(dim=1, keepdim=True)
    return (d_warped.float() + g * mask, flow_vjp(d_px, d_py), d_mask)


def boundary_dilated_warp(img_full: torch.Tensor, flow: torch.Tensor,
                          start: torch.Tensor) -> torch.Tensor:
    """``tools.boundary_dilated_warp.warp_im``: samples the uncropped image
    ``img_full`` (B, C, Hf, Wf) at ``start + grid + flow`` for a flow
    (B, 2, h, w) on the crop; ``start`` (B, 2) is the crop's (x, y) offset.

    The corner coordinates are clamped to the image and the bilinear
    weights computed from the clamped corners, over an edge-replicated
    border: interior samples are plain bilinear, edge samples replicate,
    and samples at or beyond the high edge (or below zero) cancel to zero.
    The zero-padded warp kernel does not compute this, so torch ops serve
    it on every device; autograd scatters the gathered taps' gradient."""
    b, _, ih, iw = img_full.shape
    _, _, h, w = flow.shape
    start = start.reshape(b, 2).to(device=flow.device, dtype=torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    px = xs[None, None, :] + flow[:, 0].float() + start[:, 0, None, None]
    py = ys[None, :, None] + flow[:, 1].float() + start[:, 1, None, None]
    fx, fy = torch.floor(px), torch.floor(py)
    x0 = torch.clamp(fx, 0, iw - 1)
    x1 = torch.clamp(fx + 1.0, 0, iw - 1)
    y0 = torch.clamp(fy, 0, ih - 1)
    y1 = torch.clamp(fy + 1.0, 0, ih - 1)
    p00, p01, p10, p11 = _gather_taps(img_full, fx, fy, mode="replicate")
    wa = ((x1 - px) * (y1 - py))[:, None]
    wb = ((x1 - px) * (py - y0))[:, None]
    wc = ((px - x0) * (y1 - py))[:, None]
    wd = ((px - x0) * (py - y0))[:, None]
    out = wa * p00 + wb * p10 + wc * p01 + wd * p11
    return out.to(img_full.dtype)


def _source(x: torch.Tensor, cols) -> Tuple[torch.Tensor, int]:
    """A warp's source and the output's first column: ``x`` and 0, or on
    a width-sharded frame (``cols``, ``ops/columns.py::Columns``)
    the whole gathered map and this rank's first column."""
    return (x, 0) if cols is None else (cols.gather(x), cols.lo)


def flow_warp(x: torch.Tensor, flow: torch.Tensor,
              cols=None) -> torch.Tensor:
    """``tools.torch_warp``: zero-padded bilinear warp, no mask.  With
    ``cols`` ``x`` and ``flow`` are this rank's columns of a
    width-sharded frame: the whole source is gathered, and the result is
    this rank's columns."""
    from upflow_pytorch_tpu_torch.ops.kernels import warp as kwarp

    x, x0 = _source(x, cols)
    return kwarp.warp(x.float().contiguous(), flow.float().contiguous(),
                      x0).to(x.dtype)


def flow_warp_with_mask(x: torch.Tensor, flow: torch.Tensor):
    """``WarpingLayer_no_div``: returns ``(warped * mask, mask)``, mask
    (B, H, W) = 1 where the warped all-ones image >= ``mask_threshold()``.
    ``x`` is fp32 or bf16; a bf16 map is warped in fp32 and the result
    rounded to bf16 once, as the JAX package does."""
    from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw

    return kfw.feature_warp(x.contiguous(), flow.float().contiguous(),
                            mask_threshold(), with_mask=True)


def flow_warp_masked(x: torch.Tensor, flow: torch.Tensor,
                     cols=None) -> torch.Tensor:
    """``flow_warp_with_mask``'s warped map alone; with ``cols`` on a
    width-sharded frame, as ``flow_warp``."""
    from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw

    x, x0 = _source(x, cols)
    return kfw.feature_warp(x.contiguous(), flow.float().contiguous(),
                            mask_threshold(), x0=x0)


def sgu_blend(flow_init: torch.Tensor, inter_flow: torch.Tensor,
              inter_mask: torch.Tensor) -> torch.Tensor:
    """SGU blend ``flow_warp(flow_init, inter_flow) * (1 - m) + flow_init *
    m`` (``sgu_model.forward``): flows (B, 2, H, W), mask (B, 1, H, W)."""
    from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as kb

    return kb.sgu_blend(flow_init.float().contiguous(),
                        inter_flow.float().contiguous(),
                        inter_mask.float().contiguous()).to(flow_init.dtype)


def sgu_blend_pair(flow_1: torch.Tensor, x_out_1: torch.Tensor,
                   flow_2: torch.Tensor, x_out_2: torch.Tensor, cols=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a decode level's SGU blend, from the SGU
    estimator's raw heads: per direction ``sgu_blend(flow, x[:, :2],
    sigmoid(x[:, 2:3]))``, in one kernel launch on the card.  Flows
    (B, 2, H, W); heads (B, 3, H, W), fp32 or bf16, read in place.  With
    ``cols`` on a width-sharded frame, the flows, which the blend warps,
    are gathered and the heads stay this rank's columns."""
    from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as kb

    flow_1, x0 = _source(flow_1, cols)
    flow_2, _ = _source(flow_2, cols)
    return kb.sgu_blend_pair(flow_1.float().contiguous(), x_out_1,
                             flow_2.float().contiguous(), x_out_2, x0=x0)
