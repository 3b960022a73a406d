"""Kernel 7: the SGU blend at the decode levels (``csrc/sgu_blend.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/blend.py::sgu_blend_pallas`` and
the tiers around it (``ops/warp.py::_sgu_blend_tpu_impl``):
``warp(flow, inter_flow) * (1 - m) + flow * m``, with the zero-padded
bilinear warp of ``tools.torch_warp``.  One kernel serves every
inter-flow magnitude.  Memory-bound on the H100; the source note in the
``.cu`` file says how the design meets that.

The kernel does the plain version's operations in its order, so the two
agree bit for bit.
"""

from __future__ import annotations

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    INT, PTR, check_cpu_input, check_cuda_input, count_cuda_call, launch)
from upflow_pytorch_tpu_torch.ops.kernels.warp import warp_plain


def sgu_blend_plain(flow: torch.Tensor, inter_flow: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (``_sgu_blend_xla``)."""
    count_cuda_call(sgu_blend_plain, flow, inter_flow, mask)
    return warp_plain(flow, inter_flow) * (1 - mask) + flow * mask


sgu_blend_plain.cuda_calls = 0


def sgu_blend_cuda(flow: torch.Tensor, inter_flow: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Launches ``upflow_sgu_blend`` on the current stream."""
    op = "sgu_blend"
    check_cuda_input(op, "flow", flow, (None, 2, None, None))
    b, _, h, w = flow.shape
    check_cuda_input(op, "inter_flow", inter_flow, (b, 2, h, w), flow.device)
    check_cuda_input(op, "mask", mask, (b, 1, h, w), flow.device)
    out = torch.empty_like(flow)
    fn = _build.kernel_fn("upflow_sgu_blend",
                          [PTR, PTR, PTR, PTR, INT, INT, INT, PTR])
    launch(op, sgu_blend, flow, fn, flow.data_ptr(), inter_flow.data_ptr(),
           mask.data_ptr(), out.data_ptr(), b, h, w)
    return out


def sgu_blend(flow: torch.Tensor, inter_flow: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """SGU blend: the kernel for CUDA tensors, the plain version for CPU
    tensors.  ``flow``, ``inter_flow`` (B, 2, H, W), ``mask`` (B, 1, H, W)."""
    if flow.is_cuda:
        return sgu_blend_cuda(flow, inter_flow, mask)
    check_cpu_input("sgu_blend", flow)
    return sgu_blend_plain(flow, inter_flow, mask)


sgu_blend.launches = 0
