"""Backward warping (grid sample) ops, NCHW.

Two warp semantics of the reference:

1. ``flow_warp`` — ``tools.torch_warp``: bilinear sample at ``(x+u, y+v)``
   with zeros outside the image, no validity mask.  Used by the occlusion
   check, and by ``sgu_blend`` / ``sgu_blend_pair``, the SGU's blend of a
   flow with its warp.
2. ``flow_warp_with_mask`` / ``flow_warp_masked`` — ``WarpingLayer_no_div``:
   the same sample times ``mask = (warped all-ones >= threshold)``.

Both reproduce the reference's torch ``grid_sample`` arithmetic exactly:
the fp32 normalise -> unnormalise coordinate roundtrip
(``_torch_grid_roundtrip``), the ``(x0+1)-px`` weights and the analytic
warped-ones sum (``_analytic_wsum``).  The ``>= 1.0`` mask is chaotic in
the last fp32 ulp of the flow, so every step here is a single IEEE
operation in a fixed order: no fused multiply-add and no reciprocal
multiply in place of a division.  The CUDA kernels
(``ops/kernels/feature_warp.py``, ``warp.py``, ``sgu_blend.py`` and
``sgu_final.py``) do the same operations in the same order with
``__f*_rn`` intrinsics.

Tensors: images ``(B, C, H, W)``, flows ``(B, 2, H, W)`` with channels
``(u, v)``, coordinate planes ``(B, H, W)``.
"""

from __future__ import annotations

import os
from typing import Tuple

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


def abs_coords_torch_grid(flow: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Absolute sample coords ``(px, py)``, each (B, H, W), passed through
    the grid_sample roundtrip."""
    _, _, h, w = flow.shape
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)
    px = xs[None, None, :] + flow[:, 0].float()
    py = ys[None, :, None] + flow[:, 1].float()
    return _torch_grid_roundtrip(px, w), _torch_grid_roundtrip(py, h)


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


def bilinear_sample(x: torch.Tensor, px: torch.Tensor,
                    py: torch.Tensor) -> torch.Tensor:
    """Zero-padded bilinear sample of ``x`` (B, C, Hi, Wi) at absolute
    coords (B, H, W).  Taps are read from a 2-pixel zero border, so every
    out-of-image tap reads 0; the sum is ``p00*w00 + p01*w01 + p10*w10 +
    p11*w11``, left to right."""
    b, c, ih, iw = x.shape
    _, h, w = px.shape
    x0, y0, wx0, wx1, wy0, wy1 = _tap_weights(px, py)
    xp = torch.nn.functional.pad(x.float(), (2, 2, 2, 2))
    wp = iw + 4
    sy = (torch.clamp(y0, -2, ih) + 2).long()
    sx = (torch.clamp(x0, -2, iw) + 2).long()
    flat = xp.reshape(b, c, -1)

    def tap(dy, dx):
        idx = ((sy + dy) * wp + (sx + dx)).reshape(b, 1, h * w)
        return torch.gather(flat, 2, idx.expand(b, c, h * w)
                            ).reshape(b, c, h, w)

    w00 = (wy0 * wx0)[:, None]
    w01 = (wy0 * wx1)[:, None]
    w10 = (wy1 * wx0)[:, None]
    w11 = (wy1 * wx1)[:, None]
    return (tap(0, 0) * w00 + tap(0, 1) * w01 + tap(1, 0) * w10
            + tap(1, 1) * w11)


def flow_warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``tools.torch_warp``: zero-padded bilinear warp, no mask."""
    from upflow_pytorch_tpu_torch.ops.kernels import warp as kwarp

    return kwarp.warp(x.float().contiguous(),
                      flow.float().contiguous()).to(x.dtype)


def flow_warp_with_mask(x: torch.Tensor, flow: torch.Tensor):
    """``WarpingLayer_no_div``: returns ``(warped * mask, mask)``, mask
    (B, H, W) = 1 where the warped all-ones image >= ``mask_threshold()``.
    ``x`` is fp32 or bf16; a bf16 map is warped in fp32 and the result
    rounded to bf16 once, as the JAX package does."""
    from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw

    return kfw.feature_warp(x.contiguous(), flow.float().contiguous(),
                            mask_threshold(), with_mask=True)


def flow_warp_masked(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw

    return kfw.feature_warp(x.contiguous(), flow.float().contiguous(),
                            mask_threshold())


def sgu_blend(flow_init: torch.Tensor, inter_flow: torch.Tensor,
              inter_mask: torch.Tensor) -> torch.Tensor:
    """SGU blend ``flow_warp(flow_init, inter_flow) * (1 - m) + flow_init *
    m`` (``sgu_model.forward``): flows (B, 2, H, W), mask (B, 1, H, W)."""
    from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as kb

    return kb.sgu_blend(flow_init.float().contiguous(),
                        inter_flow.float().contiguous(),
                        inter_mask.float().contiguous()).to(flow_init.dtype)


def sgu_blend_pair(flow_1: torch.Tensor, x_out_1: torch.Tensor,
                   flow_2: torch.Tensor, x_out_2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions of a decode level's SGU blend, from the SGU
    estimator's raw heads: per direction ``sgu_blend(flow, x[:, :2],
    sigmoid(x[:, 2:3]))``, in one kernel launch on the card.  Flows
    (B, 2, H, W); heads (B, 3, H, W), fp32 or bf16, read in place."""
    from upflow_pytorch_tpu_torch.ops.kernels import sgu_blend as kb

    return kb.sgu_blend_pair(flow_1.float().contiguous(), x_out_1,
                             flow_2.float().contiguous(), x_out_2)
