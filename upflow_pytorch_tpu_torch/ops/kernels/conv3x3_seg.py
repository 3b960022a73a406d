"""Kernel 6: the 3x3 convolution of the bf16 forward (``csrc/conv3x3_seg.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/conv.py::_conv3x3_seg_fwd``:

    out = bf16_rn(leaky_0.1(conv3x3_d(x) + bias))

3x3, stride 1, dilation ``d`` with zero padding ``d``; bf16 input and
weights (rounded from the fp32 parameters), exact products summed in fp32,
the fp32 bias and the LeakyReLU (slope 0.1, in fp32) applied to the sum,
one round-to-nearest-even to bf16.  Bound by operations on the H100; the
source note in the ``.cu`` file says how the design meets that.

``x`` and ``out`` may be channel ranges of larger NCHW buffers (each batch
item contiguous, any batch stride): the dense stacks of
``models/blocks.py`` read their input range and write each conv's output
into its slot of one buffer, which is what the TPU kernel's channel
segments were for.  The kernel takes its weights packed per block of
``NB`` output channels (``pack_weight``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    INT, LONG, PTR, check_cpu_input, check_cuda_input, count_cuda_call,
    stream_of)

CHUNK = 16  # input channels per stage of the kernel


def block_width(cout: int) -> int:
    """Output channels per block of the kernel (8, 16, 32 or 64): the
    widest that divides ``cout``, so narrow heads (2, 3, 8 outputs) pay
    for 8 and not for 64."""
    for nb in (64, 32, 16):
        if cout % nb == 0:
            return nb
    return 8


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the kernel's bf16 layout (Cout/NB, Cin/16, 9,
    NB, 16), Cout and Cin zero-padded up to whole blocks."""
    cout, cin = weight.shape[:2]
    nb = block_width(cout)
    n_blk = -(-cout // nb)
    n_chunk = -(-cin // CHUNK)
    w = F.pad(weight.to(torch.bfloat16),
              (0, 0, 0, 0, 0, n_chunk * CHUNK - cin, 0, n_blk * nb - cout))
    w = w.reshape(n_blk, nb, n_chunk, CHUNK, 3, 3).permute(0, 2, 4, 5, 1, 3)
    return w.reshape(n_blk, n_chunk, 9, nb, CHUNK).contiguous()


def conv3x3_seg_plain(x: torch.Tensor, weight: torch.Tensor,
                      bias: torch.Tensor, dilation: int, relu: bool,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: the bf16 input and the bf16-rounded weights
    widened to fp32, an fp32 convolution (TF32 off), the fp32 bias, the
    LeakyReLU in fp32, one rounding to bf16.  Writes into ``out`` when it
    is given and returns it."""
    count_cuda_call(conv3x3_seg_plain, x, weight)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        acc = F.conv2d(x.float(), weight.to(torch.bfloat16).float(), None,
                       padding=dilation, dilation=dilation)
    acc = acc + bias.float()[None, :, None, None]
    if relu:
        acc = torch.where(acc >= 0, acc, acc * 0.1)
    y = acc.to(torch.bfloat16)
    if out is None:
        return y
    return out.copy_(y)


conv3x3_seg_plain.cuda_calls = 0


def conv3x3_seg_cuda(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, dilation: int, relu: bool,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches ``upflow_conv3x3_seg`` on the current stream."""
    op = "conv3x3_seg"
    check_cuda_input(op, "x", x, (None, None, None, None),
                     dtypes=(torch.bfloat16,), batch_strided=True)
    b, cin, h, w = x.shape
    cout = weight.shape[0]
    if tuple(weight.shape) != (cout, cin, 3, 3) or cout == 0:
        raise ValueError("%s: weight has shape %s, expected (Cout, %d, 3, 3)"
                         % (op, tuple(weight.shape), cin))
    if tuple(bias.shape) != (cout,):
        raise ValueError("%s: bias has shape %s, expected (%d,)"
                         % (op, tuple(bias.shape), cout))
    if out is None:
        out = torch.empty((b, cout, h, w), dtype=torch.bfloat16,
                          device=x.device)
    check_cuda_input(op, "out", out, (b, cout, h, w), x.device,
                     (torch.bfloat16,), batch_strided=True)
    packed = pack_weight(weight.to(x.device))
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    fn = _build.kernel_fn("upflow_conv3x3_seg",
                          [PTR, LONG, PTR, PTR, PTR, LONG, INT, INT, INT,
                           INT, INT, INT, INT, INT, PTR])
    with torch.cuda.device(x.device):
        conv3x3_seg.launches += 1
        code = fn(x.data_ptr(), x.stride(0), packed.data_ptr(),
                  bias.data_ptr(), out.data_ptr(), out.stride(0), b, cin,
                  cout, h, w, int(dilation), int(bool(relu)),
                  block_width(cout), stream_of(x))
    _build.check_launch(op, code)
    return out


def conv3x3_seg(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                dilation: int = 1, relu: bool = True,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 3x3 conv + bias (+ LeakyReLU): the kernel for CUDA tensors, the
    plain version for CPU tensors.  ``x``: (B, Cin, H, W) bf16; ``weight``:
    (Cout, Cin, 3, 3); ``bias``: (Cout,); ``out``: an optional (B, Cout, H,
    W) bf16 destination, such as a channel slot of a dense buffer."""
    if x.is_cuda:
        return conv3x3_seg_cuda(x, weight, bias, dilation, relu, out)
    check_cpu_input("conv3x3_seg", x)
    return conv3x3_seg_plain(x, weight, bias, dilation, relu, out)


conv3x3_seg.launches = 0
