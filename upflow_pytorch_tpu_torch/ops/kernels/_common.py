"""Argument checks, the launch path and the autograd test shared by the
kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.utils.profiling import span

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float
LONG = ctypes.c_longlong

SMS = 132  # streaming multiprocessors of an H100 SXM: one wave of blocks

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
    if not (inner_contiguous(t) if batch_strided else t.is_contiguous()):
        raise ValueError("%s: %s must be contiguous%s" % (
            op, name, " within each batch item" if batch_strided else ""))


def check_columns(op: str, x0: int, w_out: int, w: int) -> None:
    """Raises unless the output columns ``[x0, x0 + w_out)`` of a warp
    kernel lie in its frame of ``w`` columns."""
    if not 0 <= x0 <= x0 + w_out <= w:
        raise ValueError("%s: columns [%d, %d) are not in a frame of %d"
                         % (op, x0, x0 + w_out, w))


def whole_frame(op: str, x0: int, w_out: int, w: int) -> None:
    """Under autograd a warp kernel's output is the whole frame: the
    column offset of the width-sharded eval has no gradient rule."""
    if (x0, w_out) != (0, w):
        raise ValueError("%s: columns [%d, %d) of %d under autograd; the "
                         "gradient rules take whole frames"
                         % (op, x0, x0 + w_out, w))


def check_cpu_input(op: str, t: torch.Tensor) -> None:
    """The plain versions serve CPU tensors only; anything else raises."""
    if t.device.type != "cpu":
        raise ValueError("%s: no kernel for device %s" % (op, t.device))


def inner_contiguous(t: torch.Tensor) -> bool:
    """Whether every item along dim 0 is contiguous (the batch stride is
    free), read from the strides without building a view."""
    if t.numel() == 0:
        return True
    expected = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expected:
            return False
        expected *= size
    return True


def launch(op: str, wrapper, t: torch.Tensor, fn, *args) -> None:
    """Calls the C entry point ``fn(*args, stream)`` on the current stream
    of ``t``'s device, inside the span ``upflow.kernel.<op>``, counts it in
    ``wrapper.launches`` and raises if the launch failed.  The current
    device is switched only when ``t`` lies on another one, and the stream
    is read as a raw handle, so the common case costs no stream object.
    The span is the host op that the profiler links the library's kernels
    to: a launch through ctypes lies inside no torch op."""
    index = t.device.index
    wrapper.launches += 1
    with span("upflow.kernel.", op):
        if index == torch.cuda.current_device():
            code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
        else:
            with torch.cuda.device(index):
                code = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    _build.check_launch(op, code)


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a wrapper's call must go through its autograd Function:
    grad mode is on and one of its inputs requires grad.  Otherwise the
    wrapper calls its kernel directly, so serving pays nothing for the
    Functions."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def count_cuda_call(fn, *tensors: torch.Tensor) -> None:
    """Counts a plain-version call on CUDA tensors in ``fn.cuda_calls``;
    the model's kernel path must leave it at 0."""
    if any(t.is_cuda for t in tensors):
        fn.cuda_calls += 1
