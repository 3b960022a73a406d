"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float


def check_cuda_input(op: str, name: str, t: torch.Tensor,
                     shape: Optional[Sequence[int]] = None,
                     device: Optional[torch.device] = None) -> None:
    """Raises unless ``t`` is a contiguous fp32 CUDA tensor of ``shape``
    (None entries match anything) on ``device``."""
    if not t.is_cuda:
        raise ValueError("%s: %s must be a CUDA tensor, got %s"
                         % (op, name, t.device))
    if device is not None and t.device != device:
        raise ValueError("%s: %s is on %s, expected %s"
                         % (op, name, t.device, device))
    if t.dtype != torch.float32:
        raise TypeError("%s: %s must be float32, got %s" % (op, name, t.dtype))
    if not t.is_contiguous():
        raise ValueError("%s: %s must be contiguous" % (op, name))
    if shape is not None and (
            t.dim() != len(shape)
            or any(s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError("%s: %s has shape %s, expected %s"
                         % (op, name, tuple(t.shape), tuple(shape)))


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
