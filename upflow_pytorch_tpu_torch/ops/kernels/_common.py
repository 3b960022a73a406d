"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
LONG = ctypes.c_longlong

FP32 = (torch.float32,)
FP32_BF16 = (torch.float32, torch.bfloat16)


def check_cuda_input(op: str, name: str, t: torch.Tensor,
                     shape: Optional[Sequence[int]] = None,
                     device: Optional[torch.device] = None,
                     dtypes: Sequence[torch.dtype] = FP32,
                     batch_strided: bool = False) -> None:
    """Raises unless ``t`` is a CUDA tensor of one of ``dtypes``, of
    ``shape`` (None entries match anything), on ``device``, and contiguous
    (with ``batch_strided``: each batch item contiguous, the batch stride
    free, as for a channel range of a larger NCHW buffer)."""
    if not t.is_cuda:
        raise ValueError("%s: %s must be a CUDA tensor, got %s"
                         % (op, name, t.device))
    if device is not None and t.device != device:
        raise ValueError("%s: %s is on %s, expected %s"
                         % (op, name, t.device, device))
    if t.dtype not in dtypes:
        raise TypeError("%s: %s must be %s, got %s"
                        % (op, name, " or ".join(map(str, dtypes)), t.dtype))
    if shape is not None and (
            t.dim() != len(shape)
            or any(s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError("%s: %s has shape %s, expected %s"
                         % (op, name, tuple(t.shape), tuple(shape)))
    if batch_strided:
        contiguous = t.shape[0] == 0 or t[0].is_contiguous()
    else:
        contiguous = t.is_contiguous()
    if not contiguous:
        raise ValueError("%s: %s must be contiguous%s" % (
            op, name, " within each batch item" if batch_strided else ""))


def check_cpu_input(op: str, t: torch.Tensor) -> None:
    """The plain versions serve CPU tensors only; anything else raises."""
    if t.device.type != "cpu":
        raise ValueError("%s: no kernel for device %s" % (op, t.device))


def stream_of(t: torch.Tensor) -> PTR:
    return PTR(torch.cuda.current_stream(t.device).cuda_stream)


def count_cuda_call(fn, *tensors: torch.Tensor) -> None:
    """Counts a plain-version call on CUDA tensors in ``fn.cuda_calls``;
    the model's kernel path must leave it at 0."""
    if any(t.is_cuda for t in tensors):
        fn.cuda_calls += 1
