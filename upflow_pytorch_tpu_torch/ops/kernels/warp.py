"""Kernel 4: the zero-padded bilinear image warp (``csrc/warp.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/warp.py::_window_warp_chw`` (via
``flow_warp_fast``): ``tools.torch_warp``, the warp of C <= 4 planes by a
flow with zeros outside the image and no mask — the occlusion check's
flow warps.  Memory-bound on the H100; the source note in the ``.cu``
file says how the design meets that.

``x0`` makes the flow and the output the columns ``[x0, x0 + w)`` of the
frame that ``x`` holds whole (the width-sharded eval,
``parallel/spatial.py``); the default 0 with a flow as wide as ``x`` is
the whole frame.  It has no gradient rule: under autograd it must be 0.
"""

from __future__ import annotations

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops import warp as _w
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    INT, PTR, check_columns, check_cpu_input, check_cuda_input,
    count_cuda_call, launch, wants_grad, whole_frame)

MAX_CHANNELS = 4  # the kernel's channel limit (csrc/warp.cu)


def warp_plain(x: torch.Tensor, flow: torch.Tensor,
               x0: int = 0) -> torch.Tensor:
    """Plain PyTorch version of the unmasked warp."""
    count_cuda_call(warp_plain, x, flow)
    px, py = _w.abs_coords_torch_grid(flow, x0, x.shape[3])
    return _w.bilinear_sample(x, px, py)


warp_plain.cuda_calls = 0


def warp_cuda(x: torch.Tensor, flow: torch.Tensor,
              x0: int = 0) -> torch.Tensor:
    """Launches ``upflow_warp`` on the current stream."""
    op = "warp"
    check_cuda_input(op, "x", x, (None, None, None, None))
    b, c, h, w = x.shape
    if c > MAX_CHANNELS:
        raise ValueError("%s: at most %d channels, got %d"
                         % (op, MAX_CHANNELS, c))
    check_cuda_input(op, "flow", flow, (b, 2, h, None), x.device)
    w_out = flow.shape[3]
    check_columns(op, x0, w_out, w)
    out = torch.empty((b, c, h, w_out), dtype=x.dtype, device=x.device)
    fn = _build.kernel_fn("upflow_warp",
                          [PTR, PTR, PTR, INT, INT, INT, INT, INT, INT, PTR])
    launch(op, warp, x, fn, x.data_ptr(), flow.data_ptr(), out.data_ptr(), b,
           c, h, w, w_out, x0)
    return out


def _warp(x: torch.Tensor, flow: torch.Tensor, x0: int = 0) -> torch.Tensor:
    if x.is_cuda:
        return warp_cuda(x, flow, x0)
    check_cpu_input("warp", x)
    return warp_plain(x, flow, x0)


class WarpFn(torch.autograd.Function):
    """``warp`` with the JAX package's gradient rule."""

    @staticmethod
    def forward(ctx, x, flow):
        ctx.save_for_backward(x, flow)
        return _warp(x, flow)

    @staticmethod
    def backward(ctx, g):
        return _w.warp_vjp(*ctx.saved_tensors, g)


def warp(x: torch.Tensor, flow: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """Unmasked warp: the kernel for CUDA tensors, the plain version for
    CPU tensors; through ``WarpFn`` under autograd."""
    if wants_grad(x, flow):
        whole_frame("warp", x0, flow.shape[3], x.shape[3])
        return WarpFn.apply(x, flow)
    return _warp(x, flow, x0)


warp.launches = 0
