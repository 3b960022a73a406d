"""Kernel 3: the normalised correlation + LeakyReLU (``csrc/corr_norm.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/corr_norm.py::
corr_norm_window_pallas``.  Memory-bound on the H100 at the fine levels,
latency-bound at the coarse ones; the source note in
``csrc/corr_tile.cuh`` (the tile body it shares with kernel 1) says how
the design meets that, and ``launch_config`` gives the tile and the
channel split for each shape, ``staging_route`` how it copies the maps
(``corr_norm.route_launches`` counts each route); both live beside
kernel 1 in ``correlation.py``.

Per-channel normalisation collapses to an affine ``(f - m) * rstd`` whose
(B, 4, C) scalars [m1, rstd1, m2, rstd2] torch reduces from the
un-normalised maps (``moments`` / ``affine_pair``); the kernel applies it
while staging, zeroes out-of-image taps after it, correlates and applies
the LeakyReLU, so no normalised map reaches device memory.

``warp_norm_corr`` is the decoder's per-level segment at levels >= 1:
masked feature warp (kernel 2) -> torch moments -> this kernel.

Under autograd ``corr_norm`` goes through ``CorrNormFn``, whose backward
(``corr_norm_vjp``) returns d f1, d f2 and d aff through the LeakyReLU
(``>= 0`` passes the gradient, as ``jax.nn.leaky_relu``), the
correlation, the zero taps outside the image and the affine; autograd
carries the moments and ``affine_pair``, and ``FeatureWarpFn`` the warp,
so ``warp_norm_corr``'s gradient is that of the unfused composition, the
JAX package's rule (``corr_norm.py::_wnc_bwd``).

bf16 maps (the bf16 forward) keep the TPU's fused semantics
(``ops/pallas/corr_norm.py::_wnc_fast``): the warped source is rounded to
bf16, the moments are taken in fp32 from the rounded values, and the
affine, the correlation and the LeakyReLU run in fp32 inside the kernel,
so the normalised maps are never rounded.  The port takes this path at
every level >= 1.  It deliberately drops the TPU's width gate
(``warp_norm_corr_viable``, ``w < 128``), which on a TPU sends the narrow
levels to the unfused composition, where the normalised maps are rounded
to bf16 as well; the whole-model comparison with the JAX package covers
that difference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.ops.kernels import feature_warp as kfw
from upflow_pytorch_tpu_torch.ops.normalize import sharded_moments
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FP32_BF16, check_cpu_input, check_cuda_input, count_cuda_call,
    wants_grad)
# the tile body's grid and staging rules, shared with the plain correlation
from upflow_pytorch_tpu_torch.ops.kernels.correlation import (  # noqa: F401
    KERNEL_DISP, SMS, SPLITS, TILES, channel_ranges, correlation_plain,
    correlation_vjp, launch_config, launch_tiles, staging_route)


def moments(f: torch.Tensor, across_channels: bool, cols=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> mean and UNBIASED variance, each (B, C).  With
    ``cols`` the map is this rank's columns of a width-sharded frame and
    the moments are the frame's (``ops/normalize.py::sharded_moments``)."""
    b, c, h, w = f.shape
    dims = (1, 2, 3) if across_channels else (2, 3)
    if cols is None:
        f = f.float()
        n = h * w * c if across_channels else h * w
        mean = f.sum(dim=dims, keepdim=True) / n
        var = ((f - mean) ** 2).sum(dim=dims) / max(n - 1, 1)
    else:
        (mean,), (var,) = sharded_moments([f], dims, cols)
        var = var.reshape(b, -1)
    mean = mean.reshape(b, -1)
    if across_channels:
        return mean.expand(b, c), var.reshape(b, 1).expand(b, c)
    return mean, var


def affine_pair(m1, v1, m2, v2, norm_kw: dict) -> torch.Tensor:
    """(B, C) moments -> (B, 4, C) [m1, rstd1, m2, rstd2] per the
    normalize_features knobs, including the cross-image var-OF-vars quirk
    (for two images, the unbiased variance of {v1, v2})."""
    if norm_kw["moments_across_images"]:
        m_all = (m1 + m2) * 0.5
        v_bar = (v1 + v2) * 0.5
        v_all = (v1 - v_bar) ** 2 + (v2 - v_bar) ** 2  # /(n-1), n=2
        m1 = m2 = m_all
        v1 = v2 = v_all
    ones = torch.ones_like(m1)
    r1 = torch.rsqrt(v1 + 1e-16) if norm_kw["normalize"] else ones
    r2 = torch.rsqrt(v2 + 1e-16) if norm_kw["normalize"] else ones
    if not norm_kw["center"]:
        m1 = m2 = torch.zeros_like(m1)
    return torch.stack([m1, r1, m2, r2], dim=1).contiguous()


def corr_norm_plain(f1: torch.Tensor, f2: torch.Tensor, aff: torch.Tensor,
                    leaky_slope: Optional[float]) -> torch.Tensor:
    """Plain PyTorch version: affine both maps, zero-padded correlation of
    the normalised maps, LeakyReLU."""
    count_cuda_call(corr_norm_plain, f1, f2, aff)
    f1n = (f1.float() - aff[:, 0, :, None, None]) * aff[:, 1, :, None, None]
    f2n = (f2.float() - aff[:, 2, :, None, None]) * aff[:, 3, :, None, None]
    out = correlation_plain(f1n, f2n, KERNEL_DISP)
    if leaky_slope is not None:
        out = F.leaky_relu(out, negative_slope=leaky_slope)
    return out


corr_norm_plain.cuda_calls = 0


def corr_norm_cuda(f1: torch.Tensor, f2: torch.Tensor, aff: torch.Tensor,
                   leaky_slope: Optional[float],
                   width: Optional[int] = None) -> torch.Tensor:
    """Launches ``upflow_corr_norm`` on the current stream."""
    op = "corr_norm"
    check_cuda_input(op, "f1", f1, (None, None, None, None),
                     dtypes=FP32_BF16)
    b, c, h, w = f1.shape
    if c == 0:
        raise ValueError("%s: no channels" % op)
    check_cuda_input(op, "f2", f2, (b, c, h, w), f1.device, (f1.dtype,))
    check_cuda_input(op, "aff", aff, (b, 4, c), f1.device)
    k = 2 * KERNEL_DISP + 1
    out = torch.empty((b, k * k, h, w), dtype=torch.float32, device=f1.device)
    # LeakyReLU with slope 1 is the identity
    slope = 1.0 if leaky_slope is None else float(leaky_slope)
    launch_tiles(op, corr_norm, f1, f2, out, aff, slope, width)
    return out


def _corr_norm(f1: torch.Tensor, f2: torch.Tensor, aff: torch.Tensor,
               leaky_slope: Optional[float],
               width: Optional[int] = None) -> torch.Tensor:
    if f1.is_cuda:
        return corr_norm_cuda(f1, f2, aff, leaky_slope, width)
    check_cpu_input("corr_norm", f1)
    return corr_norm_plain(f1, f2, aff, leaky_slope)


def corr_norm_vjp(f1: torch.Tensor, f2: torch.Tensor, aff: torch.Tensor,
                  out: torch.Tensor, leaky_slope: Optional[float],
                  g: torch.Tensor):
    """(d_f1, d_f2, d_aff) of ``corr_norm`` given its output ``out`` and
    the output's cotangent ``g``.  The LeakyReLU passes ``g`` where the
    output is >= 0 (so is its input) and ``slope * g`` elsewhere; the
    correlation's rule (``correlation_vjp``) runs on the normalised maps,
    whose zero padding lies outside the affine; the affine ``(f - m) * r``
    gives ``d_f = d_fn * r``, ``d_m = -sum(d_fn * r)`` and ``d_r =
    sum(d_fn * (f - m))`` over each channel's pixels."""
    g = g.float()
    if leaky_slope is not None:
        g = torch.where(out >= 0, g, g * leaky_slope)
    m1, r1, m2, r2 = (aff[:, i, :, None, None] for i in range(4))
    c1 = f1.float() - m1
    c2 = f2.float() - m2
    d_f1n, d_f2n = correlation_vjp(c1 * r1, c2 * r2, g, KERNEL_DISP)
    d_f1 = d_f1n * r1
    d_f2 = d_f2n * r2
    d_aff = torch.stack([-d_f1.sum(dim=(2, 3)), (d_f1n * c1).sum(dim=(2, 3)),
                         -d_f2.sum(dim=(2, 3)), (d_f2n * c2).sum(dim=(2, 3))],
                        dim=1)
    return d_f1.to(f1.dtype), d_f2.to(f2.dtype), d_aff


class CorrNormFn(torch.autograd.Function):
    """``corr_norm`` with the gradient of its plain composition."""

    @staticmethod
    def forward(ctx, f1, f2, aff, leaky_slope, width):
        out = _corr_norm(f1, f2, aff, leaky_slope, width)
        ctx.save_for_backward(f1, f2, aff, out)
        ctx.leaky_slope = leaky_slope
        return out

    @staticmethod
    def backward(ctx, g):
        f1, f2, aff, out = ctx.saved_tensors
        return corr_norm_vjp(f1, f2, aff, out, ctx.leaky_slope,
                             g) + (None, None)


def corr_norm(f1: torch.Tensor, f2: torch.Tensor, aff: torch.Tensor,
              leaky_slope: Optional[float],
              width: Optional[int] = None) -> torch.Tensor:
    """Normalised correlation: the kernel for CUDA tensors, the plain
    version for CPU tensors; through ``CorrNormFn`` under autograd.
    ``width``: the frame's width where the maps are a window of it
    (``correlation.py::launch_tiles``)."""
    if wants_grad(f1, f2, aff):
        return CorrNormFn.apply(f1, f2, aff, leaky_slope, width)
    return _corr_norm(f1, f2, aff, leaky_slope, width)


corr_norm.launches = 0
corr_norm.route_launches = {"vec": 0, "word": 0}


def warp_norm_corr(f_tgt: torch.Tensor, f_src: torch.Tensor,
                   flow: torch.Tensor, norm_kw: Optional[dict],
                   leaky_slope: Optional[float], mask_thr: float,
                   cols=None) -> torch.Tensor:
    """``leaky(corr(norm(f_tgt), norm(masked_warp(f_src, flow))))``.

    NCHW fp32 or bf16 maps (B, C, H, W), flow (B, 2, H, W); output
    (B, 81, H, W) fp32.  The warped map has ``f_src``'s type.
    ``norm_kw``: the normalize_features knobs, or None for no
    normalisation.

    With ``cols`` (``ops/columns.py::Columns``) the maps and the flow
    are this rank's columns ``[lo, hi)`` of a width-sharded frame, and so
    is the output.  The kernels run on the window ``[lo - 4, hi + 4)``
    clipped to the frame (the kernel zeroes the taps outside its maps
    after the affine, which a zero-filled column would not be): the whole
    source is gathered and warped by the flow's window, the moments are
    the frame's, taken over the rank's own columns, and the cost volume,
    on the grid of the frame's width, is cropped to them.
    """
    f_tgt, flow = f_tgt.contiguous(), flow.float().contiguous()
    x0, own = 0, slice(None)
    if cols is not None:
        d = KERNEL_DISP
        x0 = max(cols.lo - d, 0)
        own = slice(cols.lo - x0, cols.hi - x0)
        f_src = cols.gather(f_src)
        flow = cols.halo(flow, d, d, "clip")
        f_tgt = cols.halo(f_tgt, d, d, "clip")
    warped = kfw.feature_warp(f_src.contiguous(), flow, mask_thr, x0=x0)
    if norm_kw is not None:
        ac = norm_kw["moments_across_channels"]
        m1, v1 = moments(f_tgt[..., own], ac, cols)
        m2, v2 = moments(warped[..., own], ac, cols)
        aff = affine_pair(m1, v1, m2, v2, norm_kw)
    else:
        b, c = f_tgt.shape[:2]
        zeros = f_tgt.new_zeros((b, c), dtype=torch.float32)
        ones = f_tgt.new_ones((b, c), dtype=torch.float32)
        aff = torch.stack([zeros, ones, zeros, ones], dim=1)
    if cols is None:
        return corr_norm(f_tgt, warped, aff, leaky_slope)
    return corr_norm(f_tgt, warped, aff, leaky_slope, cols.width)[..., own]
