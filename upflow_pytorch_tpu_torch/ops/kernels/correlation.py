"""Kernel 1: the 81-tap cost-volume correlation (``csrc/correlation.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/correlation.py::_corr_fwd_pallas``.
Memory-bound on the H100; the source note in the ``.cu`` file says how
the design meets that.

    out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]

with ``k = (dy+D)*(2D+1) + (dx+D)`` and zeros outside ``f2``.  NCHW in,
(B, (2D+1)^2, H, W) out.  The maps are fp32 or bf16 (widened to fp32 as
they are read); the output is fp32.  ``correlation`` launches the kernel for CUDA
tensors and runs ``correlation_plain`` for CPU tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FP32_BF16, INT, PTR, check_cpu_input, check_cuda_input, count_cuda_call,
    launch)

KERNEL_DISP = 4  # the kernel's compiled displacement (corr_body.cuh)


def correlation_plain(f1: torch.Tensor, f2: torch.Tensor,
                      max_displacement: int = 4) -> torch.Tensor:
    """Plain PyTorch version: 81 shifted multiply-reduces."""
    count_cuda_call(correlation_plain, f1, f2)
    if f1.shape != f2.shape:
        raise ValueError("shape mismatch %s vs %s" % (f1.shape, f2.shape))
    b, c, h, w = f1.shape
    d = int(max_displacement)
    f1 = f1.float()
    f2p = F.pad(f2.float(), (d, d, d, d))
    outs = [(f1 * f2p[:, :, dy:dy + h, dx:dx + w]).sum(dim=1)
            for dy in range(2 * d + 1) for dx in range(2 * d + 1)]
    return torch.stack(outs, dim=1) / c


correlation_plain.cuda_calls = 0


def correlation_cuda(f1: torch.Tensor, f2: torch.Tensor,
                     max_displacement: int = 4) -> torch.Tensor:
    """Launches ``upflow_correlation`` on the current stream."""
    op = "correlation"
    if max_displacement != KERNEL_DISP:
        raise ValueError("%s: kernel is built for displacement %d, got %d"
                         % (op, KERNEL_DISP, max_displacement))
    check_cuda_input(op, "f1", f1, (None, None, None, None),
                     dtypes=FP32_BF16)
    check_cuda_input(op, "f2", f2, tuple(f1.shape), f1.device, (f1.dtype,))
    b, c, h, w = f1.shape
    if c == 0:
        raise ValueError("%s: no channels" % op)
    k = 2 * KERNEL_DISP + 1
    out = torch.empty((b, k * k, h, w), dtype=torch.float32, device=f1.device)
    fn = _build.kernel_fn("upflow_correlation" + (
        "_bf16" if f1.dtype == torch.bfloat16 else ""),
                          [PTR, PTR, PTR, INT, INT, INT, INT, PTR])
    launch(op, correlation, f1, fn, f1.data_ptr(), f2.data_ptr(),
           out.data_ptr(), b, c, h, w)
    return out


def correlation(f1: torch.Tensor, f2: torch.Tensor,
                max_displacement: int = 4) -> torch.Tensor:
    """Cost volume: the kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if f1.is_cuda:
        return correlation_cuda(f1, f2, max_displacement)
    check_cpu_input("correlation", f1)
    return correlation_plain(f1, f2, max_displacement)


correlation.launches = 0
