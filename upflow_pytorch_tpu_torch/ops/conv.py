"""The network's convolutions at bf16: the counterpart of the dispatch in
``upflow_pytorch_tpu/models/blocks.py::ConvBlock``.

A conv at bf16 takes one of two routes, chosen by shape and dtype alone.
They round differently, so the JAX package's predicate is kept as a rule
of the numerics (its TPU-only parts, the backend test and the environment
knobs, are dropped):

- **the kernel route** (``uses_kernel``): a 3x3, stride-1 conv whose input
  has at least 64 channels, on a map of at least 8 rows and 2048 pixels.
  It runs ``conv3x3_seg`` (kernel 6): fp32 sums, the bias and LeakyReLU
  in fp32, one rounding to bf16.
- **the plain-conv route** (everything else: the stride-2 pyramid convs,
  the 1x1 skip convs, ``SGUOutputConv``, the context network's last conv,
  every conv on a small map): flax ``nn.Conv(dtype=bfloat16)`` +
  ``nn.leaky_relu``, which rounds three times: the conv (fp32 sums) to
  bf16, the bias added in bf16, the LeakyReLU in bf16 with a bf16 slope.
  This is a library convolution (cuDNN on the card), as the JAX package
  leaves it to XLA.  The bias is never passed to ``F.conv2d``, which would
  add it before the rounding.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.ops.kernels.conv3x3_seg import (
    conv3x3_seg, packed_params)

KERNEL_MIN_CHANNELS = 64
KERNEL_MIN_ROWS = 8
KERNEL_MIN_PIXELS = 2048


def uses_kernel(cin: int, h: int, w: int, kernel_size: int, stride: int,
                dtype: torch.dtype) -> bool:
    """Whether a conv takes ``conv3x3_seg`` (``blocks.py``'s predicate)."""
    return (kernel_size == 3 and stride == 1 and dtype == torch.bfloat16
            and cin >= KERNEL_MIN_CHANNELS and h >= KERNEL_MIN_ROWS
            and h * w >= KERNEL_MIN_PIXELS)


def conv_plain_route(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, stride: int, padding: int,
                     dilation: int, relu: bool) -> torch.Tensor:
    """``nn.Conv(dtype=bfloat16)`` + ``nn.leaky_relu`` on a bf16 map."""
    w = weight.to(torch.bfloat16)
    if x.is_cuda:
        y = F.conv2d(x, w, None, stride, padding, dilation)
    else:
        # fp32 sums of the bf16 values, rounded once, as a bf16 conv with
        # fp32 accumulation gives them; PyTorch's bf16 conv on the CPU
        # differs from flax by more than an ulp
        y = F.conv2d(x.float(), w.float(), None, stride, padding,
                     dilation).to(torch.bfloat16)
    y = y + bias.to(torch.bfloat16)[None, :, None, None]
    if relu:
        # the product with the bf16 slope, rounded: the fp32 slope of
        # F.leaky_relu gives another value on a fifth of the negatives
        y = torch.where(y >= 0, y, y * torch.tensor(0.1, dtype=y.dtype))
    return y


def conv_bf16(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              stride: int, padding: int, dilation: int, relu: bool,
              out: Optional[torch.Tensor] = None,
              owner=None) -> torch.Tensor:
    """One ``ConvBlock`` at bf16 on the route its shape selects; writes
    into ``out`` when it is given and returns it.  On the kernel route
    with a CUDA input the weights come packed from ``owner``'s cache
    (``packed_params``) when an owner is given."""
    _, cin, h, w = x.shape
    if uses_kernel(cin, h, w, weight.shape[-1], stride, x.dtype):
        packed = (packed_params(owner, weight, bias)
                  if owner is not None and x.is_cuda else None)
        return conv3x3_seg(x, weight, bias, dilation, relu, out, packed)
    y = conv_plain_route(x, weight, bias, stride, padding, dilation, relu)
    return y if out is None else out.copy_(y)
