"""Kernel 7: the SGU blend at the decode levels (``csrc/sgu_blend.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/blend.py::sgu_blend_pallas`` and
the tiers around it (``ops/warp.py::_sgu_blend_tpu_impl``):
``warp(flow, inter_flow) * (1 - m) + flow * m``, with the zero-padded
bilinear warp of ``tools.torch_warp``.  One kernel serves every
inter-flow magnitude.

Two entry points, one kernel:

- ``sgu_blend_pair(flow_1, x_out_1, flow_2, x_out_2)``: both directions of
  a decode level in one launch, each reading the SGU estimator's raw
  (B, 3, H, W) head in place (fp32, or bf16 on the bf16 path): the
  inter-flow is its channels 0-1, the mask the sigmoid of channel 2.  The
  model's path.
- ``sgu_blend(flow, inter_flow, mask)``: one direction with the mask
  given (already a sigmoid), the counterpart of the JAX op
  ``ops/warp.py::sgu_blend``; on CUDA it launches the same kernel.

Both count their launches in ``sgu_blend.launches``, the kernel's count,
and their plain versions' calls on CUDA tensors in
``sgu_blend_plain.cuda_calls``.  The kernel does the plain version's
operations in its order (the sigmoid as ``torch.sigmoid`` computes it on
CUDA), so the two agree bit for bit.  The source note in the ``.cu`` file
says how the design meets the card's bound.

Under autograd both go through ``SguBlendPairFn`` / ``SguBlendFn``,
whose backward is the JAX package's rule (``ops/warp.py::
_sgu_blend_tpu_bwd``: the VJP of ``_sgu_blend_xla``), through the
sigmoid for the raw heads (``ops/warp.py::sgu_blend_vjp``).

``x0`` (of the pair and of ``sgu_blend_plain``) makes the heads and the
output the columns ``[x0, x0 + w)`` of the frame whose flows the caller
passes whole (the width-sharded eval, ``parallel/spatial.py``): the flow
is the warp's source, and its value at the pixel's global column the
blend's own.  The default 0 with heads as wide as the flows is the whole
frame.  It has no gradient rule: under autograd it must be 0.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops import warp as _w
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FP32_BF16, INT, LONG, PTR, SMS, check_columns, check_cpu_input,
    check_cuda_input, count_cuda_call, launch, wants_grad, whole_frame)
from upflow_pytorch_tpu_torch.ops.kernels.warp import warp_plain
from upflow_pytorch_tpu_torch.utils.profiling import span

BLOCK_X = 32  # threads along a row (csrc/sgu_blend.cu kBlockX)
BLOCK_ROWS = (8, 4, 2, 1)  # block heights the wrapper chooses from
# half the threads an H100 holds (4 blocks of 256 an SM): above it a
# launch takes 2 pixels a thread
VECTOR_MIN_PIXELS = SMS * 4 * 256


def launch_config(ndir: int, b: int, h: int, w: int,
                  vector: bool = True) -> Tuple[int, int, int]:
    """(pixels a thread, block rows, blocks) of one launch over ``ndir``
    directions of a (b, ., h, w) level.

    2 pixels a thread, with 8-byte accesses, where the row allows them
    (``vector`` and an even width) and one-pixel threads would fill more
    than half of the card (``VECTOR_MIN_PIXELS``): there the bytes set
    the time.  On the smaller levels a launch's latency sets it, and a
    thread with one pixel ends sooner (``scripts/torch_kernel_sweep.py``:
    at B=4 384x1280 one pixel a thread is 0.2-0.5 us faster at levels 1-3,
    two pixels 0.5 us faster at level 4).  Blocks of 32 x R threads, the
    tallest R (at most 8) that still gives every SM a block; where even
    one-row blocks cannot, one-row blocks."""
    pix = (2 if vector and w % 2 == 0
           and ndir * b * h * w > VECTOR_MIN_PIXELS else 1)
    cols = -(-w // (BLOCK_X * pix))
    for rows in BLOCK_ROWS:
        blocks = cols * -(-h // rows) * ndir * b
        if blocks >= SMS:
            break
    return pix, rows, blocks


def sgu_blend_plain(flow: torch.Tensor, inter_flow: torch.Tensor,
                    mask: torch.Tensor, x0: int = 0) -> torch.Tensor:
    """Plain PyTorch version (``_sgu_blend_xla``)."""
    count_cuda_call(sgu_blend_plain, flow, inter_flow, mask)
    own = flow[..., x0:x0 + inter_flow.shape[3]]
    return warp_plain(flow, inter_flow, x0) * (1 - mask) + own * mask


sgu_blend_plain.cuda_calls = 0


def sgu_blend_pair_plain(flow_1: torch.Tensor, x_out_1: torch.Tensor,
                         flow_2: torch.Tensor, x_out_2: torch.Tensor,
                         x0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the pair: per direction
    ``sgu_blend_plain(flow, x[:, :2].float(), sigmoid(x[:, 2:3].float()))``."""
    return tuple(sgu_blend_plain(fl, x[:, :2].float(),
                                 torch.sigmoid(x[:, 2:3].float()), x0)
                 for fl, x in ((flow_1, x_out_1), (flow_2, x_out_2)))


def _same_layout(op: str, name: str, t: torch.Tensor,
                 like: torch.Tensor) -> None:
    """Raises unless ``t`` has the device, dtype, shape and strides of
    ``like``, a tensor already checked."""
    if (t.device != like.device or t.dtype != like.dtype
            or t.shape != like.shape or t.stride() != like.stride()):
        raise ValueError(
            "%s: %s must match its first direction (%s %s %s strides %s), "
            "got %s %s %s strides %s"
            % (op, name, like.device, like.dtype, tuple(like.shape),
               like.stride(), t.device, t.dtype, tuple(t.shape), t.stride()))


_ARGTYPES = [PTR] * 8 + [INT, LONG, LONG] + [INT] * 9 + [PTR]


def _launch(flow: torch.Tensor, ptrs: Sequence[int],
            ndir: int, iflow_bstride: int, mask_bstride: int,
            head: torch.Tensor, logit: bool, w_out: int, x0: int) -> None:
    """Launches ``upflow_sgu_blend`` on ``ptrs``, the (flow, inter-flow,
    mask, out) addresses of each of the ``ndir`` directions, whose flows
    have ``flow``'s shape and whose outputs are its columns ``[x0, x0 +
    w_out)``.  2 pixels a thread where every address is a multiple of two
    of its elements, the head's batch strides are even, and so are the
    flows' width and ``x0``."""
    b, _, h, w = flow.shape
    flows = heads = 0
    for i in range(0, len(ptrs), 4):
        flows |= ptrs[i] | ptrs[i + 3]
        heads |= ptrs[i + 1] | ptrs[i + 2]
    vector = (flows % 8 == 0 and heads % (2 * head.element_size()) == 0
              and (iflow_bstride | mask_bstride) % 2 == 0
              and (w | x0) % 2 == 0)
    pix, rows, _ = launch_config(ndir, b, h, w_out, vector)
    if ndir == 1:
        ptrs = tuple(ptrs) * 2
    fn = _build.kernel_fn("upflow_sgu_blend", _ARGTYPES)
    launch("sgu_blend", sgu_blend, flow, fn, *ptrs, ndir, iflow_bstride,
           mask_bstride, b, h, w, w_out, x0,
           int(head.dtype == torch.bfloat16), int(logit), pix, rows)


def sgu_blend_pair_cuda(flow_1: torch.Tensor, x_out_1: torch.Tensor,
                        flow_2: torch.Tensor, x_out_2: torch.Tensor,
                        x0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launches ``upflow_sgu_blend`` once for both directions, reading the
    raw heads in place (the mask logit is each head's third plane)."""
    op = "sgu_blend_pair"
    check_cuda_input(op, "flow_1", flow_1, (None, 2, None, None))
    _same_layout(op, "flow_2", flow_2, flow_1)
    b, _, h, w = flow_1.shape
    check_cuda_input(op, "x_out_1", x_out_1, (b, 3, h, None), flow_1.device,
                     FP32_BF16, batch_strided=True)
    _same_layout(op, "x_out_2", x_out_2, x_out_1)
    w_out = x_out_1.shape[3]
    check_columns(op, x0, w_out, w)
    out = torch.empty((2, b, 2, h, w_out), dtype=torch.float32,
                      device=flow_1.device)
    out_1, out_2 = out.unbind(0)
    mask_offset = 2 * h * w_out * x_out_1.element_size()
    x_1, x_2 = x_out_1.data_ptr(), x_out_2.data_ptr()
    _launch(flow_1, (flow_1.data_ptr(), x_1, x_1 + mask_offset,
                          out_1.data_ptr(), flow_2.data_ptr(), x_2,
                          x_2 + mask_offset, out_2.data_ptr()),
            2, x_out_1.stride(0), x_out_1.stride(0), x_out_1, True, w_out,
            x0)
    return out_1, out_2


def sgu_blend_cuda(flow: torch.Tensor, inter_flow: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Launches ``upflow_sgu_blend`` for one direction with the mask
    given."""
    op = "sgu_blend"
    check_cuda_input(op, "flow", flow, (None, 2, None, None))
    b, _, h, w = flow.shape
    check_cuda_input(op, "inter_flow", inter_flow, (b, 2, h, w), flow.device)
    check_cuda_input(op, "mask", mask, (b, 1, h, w), flow.device)
    out = torch.empty_like(flow)
    _launch(flow, (flow.data_ptr(), inter_flow.data_ptr(),
                        mask.data_ptr(), out.data_ptr()),
            1, 2 * h * w, h * w, inter_flow, False, w, 0)
    return out


def _sgu_blend_pair(flow_1, x_out_1, flow_2, x_out_2, x0=0):
    if flow_1.is_cuda:
        return sgu_blend_pair_cuda(flow_1, x_out_1, flow_2, x_out_2, x0)
    check_cpu_input("sgu_blend_pair", flow_1)
    return sgu_blend_pair_plain(flow_1, x_out_1, flow_2, x_out_2, x0)


def _sgu_blend(flow, inter_flow, mask):
    if flow.is_cuda:
        return sgu_blend_cuda(flow, inter_flow, mask)
    check_cpu_input("sgu_blend", flow)
    return sgu_blend_plain(flow, inter_flow, mask)


def head_vjp(flow: torch.Tensor, x_out: torch.Tensor, g: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_flow, d_x_out) of one direction of the pair given its output's
    cotangent: ``sgu_blend_vjp`` with the mask ``sigmoid(x_out[:, 2:3])``,
    the mask's gradient taken through the sigmoid, ``d_x_out`` in the
    head's type."""
    mask = torch.sigmoid(x_out[:, 2:3].float())
    d_flow, d_iflow, d_mask = _w.sgu_blend_vjp(
        flow, x_out[:, :2].float(), mask, g)
    d_logit = d_mask * mask * (1 - mask)
    return d_flow, torch.cat([d_iflow, d_logit], dim=1).to(x_out.dtype)


class SguBlendPairFn(torch.autograd.Function):
    """``sgu_blend_pair`` with the JAX package's gradient rule."""

    @staticmethod
    def forward(ctx, flow_1, x_out_1, flow_2, x_out_2):
        ctx.save_for_backward(flow_1, x_out_1, flow_2, x_out_2)
        return _sgu_blend_pair(flow_1, x_out_1, flow_2, x_out_2)

    @staticmethod
    def backward(ctx, g_1, g_2):
        with span("upflow.rule.SguBlendPairFn"):
            flow_1, x_out_1, flow_2, x_out_2 = ctx.saved_tensors
            return (head_vjp(flow_1, x_out_1, g_1)
                    + head_vjp(flow_2, x_out_2, g_2))


class SguBlendFn(torch.autograd.Function):
    """``sgu_blend`` with the JAX package's gradient rule."""

    @staticmethod
    def forward(ctx, flow, inter_flow, mask):
        ctx.save_for_backward(flow, inter_flow, mask)
        return _sgu_blend(flow, inter_flow, mask)

    @staticmethod
    def backward(ctx, g):
        with span("upflow.rule.SguBlendFn"):
            return _w.sgu_blend_vjp(*ctx.saved_tensors, g)


def sgu_blend_pair(flow_1: torch.Tensor, x_out_1: torch.Tensor,
                   flow_2: torch.Tensor, x_out_2: torch.Tensor,
                   x0: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both directions' SGU blend from the raw heads: the kernel (one
    launch) for CUDA tensors, the plain version for CPU tensors; through
    ``SguBlendPairFn`` under autograd.  Flows (B, 2, H, W) fp32, heads
    (B, 3, H, w) fp32 or bf16, the frame's columns ``[x0, x0 + w)``."""
    if wants_grad(flow_1, x_out_1, flow_2, x_out_2):
        whole_frame("sgu_blend_pair", x0, x_out_1.shape[3],
                    flow_1.shape[3])
        return SguBlendPairFn.apply(flow_1, x_out_1, flow_2, x_out_2)
    return _sgu_blend_pair(flow_1, x_out_1, flow_2, x_out_2, x0)


def sgu_blend(flow: torch.Tensor, inter_flow: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """SGU blend of one direction with the mask given: the kernel for
    CUDA tensors, the plain version for CPU tensors; through
    ``SguBlendFn`` under autograd.  ``flow``, ``inter_flow`` (B, 2, H, W),
    ``mask`` (B, 1, H, W)."""
    if wants_grad(flow, inter_flow, mask):
        return SguBlendFn.apply(flow, inter_flow, mask)
    return _sgu_blend(flow, inter_flow, mask)


sgu_blend.launches = 0
