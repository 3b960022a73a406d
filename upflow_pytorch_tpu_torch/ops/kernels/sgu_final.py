"""Kernel 8: the final SGU stage (``csrc/sgu_final.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/sgu_final.py::sgu_final_pallas``
and the tiers around it (``models/upflow.py::_sgu_final_op_impl``): for
one direction, the rate-scaled align-corners upsample of the
quarter-resolution flow and inter-flow, the upsample of the sigmoided
mask, and the blend ``warp(flow, inter_flow) * (1 - m) + flow * m`` at full
resolution, with no full-resolution intermediate in device memory.  One
kernel serves every inter-flow magnitude.  Memory-bound on the H100; the
source note in the ``.cu`` file says how the design meets that.

The plain version resizes with matrix products; the kernel lerps, and
rounds each two-tap lerp as a product that accumulates over the source
index with fused multiply-adds does (torch's CPU product and cuBLAS on
the H100 both do), so the two agree bit for bit there.

Under autograd ``sgu_final`` goes through ``SguFinalFn``, whose backward
is the JAX package's rule (``models/upflow.py::_sgu_final_op_bwd``: the
VJP of ``_sgu_final_xla``), ``sgu_final_vjp``: the blend's gradient at
full resolution, then the rate scales, the transposed resizes and the
sigmoid.

``x0`` and ``w_out`` make the output the columns ``[x0, x0 + w_out)`` of
the (H, W) frame (the width-sharded eval, ``parallel/spatial.py``), from
the whole quarter-resolution flow and head; the defaults are the whole
frame.  They have no gradient rule: under autograd the output is the
whole frame.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops import warp as _w
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FLOAT, INT, PTR, SMS, check_columns, check_cpu_input, check_cuda_input,
    count_cuda_call, launch, wants_grad, whole_frame)
from upflow_pytorch_tpu_torch.ops.kernels.sgu_blend import sgu_blend_plain
from upflow_pytorch_tpu_torch.ops.resize import (
    interp_taps, resize_vjp, upsample2d_as, upsample2d_flow_as)

Size = Tuple[int, int]

TILE_W = 128  # output columns of the kernel's tile
TILE_ROWS = (32, 16)  # its tile heights, tallest first


def tile_rows(b: int, h: int, w: int) -> int:
    """The kernel's tile height for a (b, 2, h, w) output: the tallest
    whose grid gives every SM a block, else the shortest.  A taller tile
    stages its halo of row lerps (40 rows each side) for more pixels."""
    for rows in TILE_ROWS:
        if b * -(-h // rows) * -(-w // TILE_W) >= SMS:
            return rows
    return TILE_ROWS[-1]


def sgu_final_plain(flow_q: torch.Tensor, x_out: torch.Tensor,
                    out_hw: Size, x0: int = 0,
                    w_out: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version (``_sgu_final_xla``): ``flow_q`` (B, 2, Hq,
    Wq), ``x_out`` (B, 3, Hq, Wq) -> (B, 2, H, w_out), the columns ``[x0,
    x0 + w_out)`` of the (H, W) result (by default all of it)."""
    count_cuda_call(sgu_final_plain, flow_q, x_out)
    cols = slice(x0, int(out_hw[1]) if w_out is None else x0 + w_out)
    flow = upsample2d_flow_as(flow_q, out_hw, if_rate=True)
    inter_flow = upsample2d_flow_as(x_out[:, :2], out_hw, if_rate=True)
    mask = upsample2d_as(torch.sigmoid(x_out[:, 2:3]), out_hw)
    return sgu_blend_plain(flow, inter_flow[..., cols], mask[..., cols], x0)


sgu_final_plain.cuda_calls = 0


def sgu_final_cuda(flow_q: torch.Tensor, x_out: torch.Tensor,
                   out_hw: Size, x0: int = 0,
                   w_out: Optional[int] = None) -> torch.Tensor:
    """Launches ``upflow_sgu_final`` on the current stream.  The sigmoid
    of the mask logit runs in torch at quarter resolution."""
    op = "sgu_final"
    check_cuda_input(op, "flow_q", flow_q, (None, 2, None, None))
    b, _, hq, wq = flow_q.shape
    check_cuda_input(op, "x_out", x_out, (b, 3, hq, wq), flow_q.device)
    h, w = int(out_hw[0]), int(out_hw[1])
    w_out = w - x0 if w_out is None else w_out
    check_columns(op, x0, w_out, w)
    mask_q = torch.sigmoid(x_out[:, 2:3]).contiguous()
    row_idx, row_wt = interp_taps(h, hq, flow_q.device)
    col_idx, col_wt = interp_taps(w, wq, flow_q.device)
    out = torch.empty((b, 2, h, w_out), dtype=torch.float32,
                      device=flow_q.device)
    fn = _build.kernel_fn("upflow_sgu_final",
                          [PTR, PTR, PTR, PTR, PTR, PTR, PTR, PTR, INT, INT,
                           INT, INT, INT, INT, INT, FLOAT, FLOAT, INT, PTR])
    launch(op, sgu_final, flow_q, fn, flow_q.data_ptr(), x_out.data_ptr(),
           mask_q.data_ptr(), row_idx.data_ptr(), row_wt.data_ptr(),
           col_idx.data_ptr(), col_wt.data_ptr(), out.data_ptr(), b, hq, wq, h,
           w, w_out, x0, w / wq, h / hq, tile_rows(b, h, w_out))
    return out


def _sgu_final(flow_q: torch.Tensor, x_out: torch.Tensor, out_hw: Size,
               x0: int = 0, w_out: Optional[int] = None) -> torch.Tensor:
    if flow_q.is_cuda:
        return sgu_final_cuda(flow_q, x_out, out_hw, x0, w_out)
    check_cpu_input("sgu_final", flow_q)
    return sgu_final_plain(flow_q, x_out, out_hw, x0, w_out)


def _rate_scale(flow: torch.Tensor, su: float, sv: float) -> torch.Tensor:
    return torch.stack([flow[:, 0] * su, flow[:, 1] * sv], dim=1)


def sgu_final_vjp(flow_q: torch.Tensor, x_out: torch.Tensor, out_hw: Size,
                  g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_flow_q, d_x_out) of the final stage given the cotangent ``g`` of
    its (B, 2, H, W) output: the full-resolution flow, inter-flow and mask
    recomputed by torch ops, the blend's gradient (``sgu_blend_vjp``),
    then back through the rate scales, the resizes (``resize_vjp``) and
    the sigmoid."""
    hq, wq = flow_q.shape[2:]
    h, w = int(out_hw[0]), int(out_hw[1])
    su, sv = w / wq, h / hq
    sig = torch.sigmoid(x_out[:, 2:3])
    d_flow, d_iflow, d_mask = _w.sgu_blend_vjp(
        upsample2d_flow_as(flow_q, (h, w), if_rate=True),
        upsample2d_flow_as(x_out[:, :2], (h, w), if_rate=True),
        upsample2d_as(sig, (h, w)), g)
    d_fq = resize_vjp(_rate_scale(d_flow, su, sv), (hq, wq))
    d_iq = resize_vjp(_rate_scale(d_iflow, su, sv), (hq, wq))
    d_logit = resize_vjp(d_mask, (hq, wq)) * sig * (1 - sig)
    return d_fq, torch.cat([d_iq, d_logit], dim=1)


class SguFinalFn(torch.autograd.Function):
    """``sgu_final`` with the JAX package's gradient rule."""

    @staticmethod
    def forward(ctx, flow_q, x_out, out_hw):
        ctx.save_for_backward(flow_q, x_out)
        ctx.out_hw = out_hw
        return _sgu_final(flow_q, x_out, out_hw)

    @staticmethod
    def backward(ctx, g):
        flow_q, x_out = ctx.saved_tensors
        return sgu_final_vjp(flow_q, x_out, ctx.out_hw, g) + (None,)


def sgu_final(flow_q: torch.Tensor, x_out: torch.Tensor, out_hw: Size,
              x0: int = 0, w_out: Optional[int] = None) -> torch.Tensor:
    """Final SGU stage: the kernel for CUDA tensors, the plain version for
    CPU tensors; through ``SguFinalFn`` under autograd."""
    if wants_grad(flow_q, x_out):
        w = int(out_hw[1])
        whole_frame("sgu_final", x0, w if w_out is None else w_out, w)
        return SguFinalFn.apply(flow_q, x_out, out_hw)
    return _sgu_final(flow_q, x_out, out_hw, x0, w_out)


sgu_final.launches = 0
