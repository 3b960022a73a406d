"""Kernel 2: the masked bilinear feature warp (``csrc/feature_warp.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/feature_warp.py::
feature_warp_window_pallas``: ``WarpingLayer_no_div``, the zero-padded
bilinear warp of a (B, C, H, W) feature map by a (B, 2, H, W) flow, times
``mask = (warped all-ones >= thr)``.  Memory-bound on the H100, and
latency-bound on the coarse levels' small maps; the source note in the
``.cu`` file says how the design meets that, and ``launch_config`` gives
the grid for each shape.

The kernel reproduces ``ops/warp.py``'s arithmetic op for op, so kernel
and plain version agree bit for bit, mask bits included.  Maps are fp32
or bf16 and the output has the map's type: a bf16 map is warped in fp32
and the result rounded to bf16 once (the TPU kernel's ``out_dtype``).

Under autograd ``feature_warp`` goes through ``FeatureWarpFn``, whose
backward is the JAX package's rule (``feature_warp.py::
_feature_warp_bwd``): the gradient of the sample times the mask, the mask
a constant.  The forward saves the mask the kernel returns, so the
backward never recomputes the chaotic ``>= thr`` bits.

``x0`` makes the flow, the output and the mask the columns ``[x0, x0 +
w)`` of the frame that ``x`` holds whole (the width-sharded eval,
``parallel/spatial.py``); the default 0 with a flow as wide as ``x`` is
the whole frame.  It has no gradient rule: under autograd it must be 0.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops import warp as _w
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FLOAT, FP32_BF16, INT, PTR, SMS, check_columns, check_cpu_input,
    check_cuda_input, count_cuda_call, launch, wants_grad, whole_frame)

Result = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]

TARGET_BLOCKS = 4 * SMS  # the grid the launch configuration aims for
THREADS = (128, 64)  # block sizes, largest first
UNROLL = 4  # the kernel's channels per step (gathers issued together)


def launch_config(b: int, c: int, h: int, w: int) -> Tuple[int, int, int,
                                                          int]:
    """(threads, pixel blocks, channel groups, channels per group) of the
    kernel's grid (pixel blocks x groups x batch items) for a (b, c, h, w)
    map.  The pixels alone take one group of all ``c`` channels when they
    fill ``TARGET_BLOCKS``; smaller maps split the channels into groups (a
    multiple of ``UNROLL`` channels each, or fewer than ``UNROLL``) until
    the grid reaches the target, and take smaller blocks where even one
    channel a group leaves fewer than ``SMS`` blocks."""
    plane = h * w
    for threads in THREADS:
        pixel_blocks = -(-plane // threads)
        base = max(1, b * pixel_blocks)
        size = max(1, -(-c // -(-TARGET_BLOCKS // base)))
        if size > UNROLL:
            size = -(-size // UNROLL) * UNROLL
        groups = max(1, -(-c // size))
        if base * groups >= SMS:
            break
    return threads, pixel_blocks, groups, size


def feature_warp_plain(x: torch.Tensor, flow: torch.Tensor, thr: float,
                       with_mask: bool = False, x0: int = 0) -> Result:
    """Plain PyTorch version: returns ``warp(x) * mask`` in ``x``'s type
    and, with ``with_mask``, the (B, H, W) fp32 mask."""
    count_cuda_call(feature_warp_plain, x, flow)
    _, _, ih, iw = x.shape
    px, py = _w.abs_coords_torch_grid(flow, x0, iw)
    out = _w.bilinear_sample(x, px, py)
    mask = (_w._analytic_wsum(ih, iw, px, py) >= thr).float()
    out = (out * mask[:, None]).to(x.dtype)
    return (out, mask) if with_mask else out


feature_warp_plain.cuda_calls = 0


def feature_warp_cuda(x: torch.Tensor, flow: torch.Tensor, thr: float,
                      with_mask: bool = False, x0: int = 0) -> Result:
    """Launches ``upflow_feature_warp`` on the current stream."""
    op = "feature_warp"
    check_cuda_input(op, "x", x, (None, None, None, None),
                     dtypes=FP32_BF16)
    b, c, h, w = x.shape
    check_cuda_input(op, "flow", flow, (b, 2, h, None), x.device)
    w_out = flow.shape[3]
    check_columns(op, x0, w_out, w)
    out = torch.empty((b, c, h, w_out), dtype=x.dtype, device=x.device)
    mask = (torch.empty((b, h, w_out), dtype=torch.float32, device=x.device)
            if with_mask else None)
    threads, _, groups, size = launch_config(b, c, h, w_out)
    fn = _build.kernel_fn("upflow_feature_warp" + (
        "_bf16" if x.dtype == torch.bfloat16 else ""),
                          [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, INT,
                           FLOAT, INT, INT, INT, PTR])
    launch(op, feature_warp, x, fn, x.data_ptr(), flow.data_ptr(),
           out.data_ptr(), mask.data_ptr() if with_mask else None, b, c, h, w,
           w_out, x0, float(thr), threads, groups, size)
    return (out, mask) if with_mask else out


def _feature_warp(x: torch.Tensor, flow: torch.Tensor, thr: float,
                  with_mask: bool, x0: int = 0) -> Result:
    if x.is_cuda:
        return feature_warp_cuda(x, flow, thr, with_mask, x0)
    check_cpu_input("feature_warp", x)
    return feature_warp_plain(x, flow, thr, with_mask, x0)


class FeatureWarpFn(torch.autograd.Function):
    """``feature_warp`` with the JAX package's gradient rule; returns the
    warp and the (non-differentiable) mask."""

    @staticmethod
    def forward(ctx, x, flow, thr):
        out, mask = _feature_warp(x, flow, thr, True)
        ctx.save_for_backward(x, flow, mask)
        ctx.mark_non_differentiable(mask)
        return out, mask

    @staticmethod
    def backward(ctx, g, _g_mask):
        x, flow, mask = ctx.saved_tensors
        d_x, d_flow = _w.warp_vjp(x, flow, g.float() * mask[:, None])
        return d_x, d_flow, None


def feature_warp(x: torch.Tensor, flow: torch.Tensor, thr: float,
                 with_mask: bool = False, x0: int = 0) -> Result:
    """Masked warp: the kernel for CUDA tensors, the plain version for CPU
    tensors; through ``FeatureWarpFn`` under autograd."""
    if wants_grad(x, flow):
        whole_frame("feature_warp", x0, flow.shape[3], x.shape[3])
        out, mask = FeatureWarpFn.apply(x, flow, thr)
        return (out, mask) if with_mask else out
    return _feature_warp(x, flow, thr, with_mask, x0)


feature_warp.launches = 0
