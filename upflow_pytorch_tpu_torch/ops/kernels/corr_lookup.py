"""RAFT's correlation lookup (``csrc/corr_lookup.cu``) and its plain
version.

``CorrBlock.__call__`` of princeton-vl/RAFT ``core/corr.py``: for every
pixel of the 1/8 grid, its own rows of the 4-level all-pairs volume
sampled bilinearly (``grid_sample``, ``align_corners=True``, zeros
outside) in a 9 x 9 window around ``coords / 2^level``.  The 324 values
are the channels of an NCHW map, level-major, then ``i * 9 + j`` for the
x offset ``i - 4`` and the y offset ``j - 4`` (``meshgrid(dy, dx)`` in
corr.py makes the x offset the slow axis), in the dtype the motion
encoder's ``convc1`` reads.  Memory-bound on the H100; the source note in
the ``.cu`` file says how the design meets that.

The plain version is corr.py's, through ``bilinear_sampler``; the kernel
takes the fractional offsets from the coordinates directly, without
``grid_sample``'s normalising round trip, so the two agree to fp32
rounding.  There is no gradient rule: RAFT's training is not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FP32_BF16, INT, PTR, check_cpu_input, check_cuda_input, count_cuda_call,
    launch, wants_grad)

LEVELS = 4
RADIUS = 4
TAPS = (2 * RADIUS + 1) ** 2  # a level's window
CHANNELS = LEVELS * TAPS  # 324


def bilinear_sampler(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """corr.py's ``bilinear_sampler``: ``img`` (B, C, H, W) sampled at the
    pixel coordinates ``coords`` (B, h, w, 2), x then y, by
    ``grid_sample`` with ``align_corners=True`` and zero padding."""
    h, w = img.shape[-2:]
    xgrid, ygrid = coords.split([1, 1], dim=-1)
    xgrid = 2 * xgrid / (w - 1) - 1
    ygrid = 2 * ygrid / (h - 1) - 1
    grid = torch.cat([xgrid, ygrid], dim=-1)
    return F.grid_sample(img, grid, align_corners=True)


def window_offsets(device=None) -> torch.Tensor:
    """(9, 9, 2): entry [i, j] is the (x, y) offset (i - 4, j - 4), as
    ``stack(meshgrid(dy, dx), -1)`` gives it in corr.py."""
    d = torch.linspace(-RADIUS, RADIUS, 2 * RADIUS + 1, device=device)
    return torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)


def corr_lookup_plain(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version: corr.py's lookup, fp32, cast to ``dtype``."""
    count_cuda_call(corr_lookup_plain, coords)
    n, _, h, w = coords.shape
    centroid = coords.permute(0, 2, 3, 1).reshape(n * h * w, 1, 1, 2)
    delta = window_offsets(coords.device).view(1, 2 * RADIUS + 1,
                                               2 * RADIUS + 1, 2)
    out = [bilinear_sampler(vol, centroid / 2 ** i + delta).view(n, h, w, -1)
           for i, vol in enumerate(levels)]
    return torch.cat(out, dim=-1).permute(0, 3, 1, 2).contiguous().to(dtype)


corr_lookup_plain.cuda_calls = 0


def corr_lookup_cuda(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launches ``upflow_corr_lookup`` on the current stream: one launch
    for every level and batch item."""
    op = "corr_lookup"
    check_cuda_input(op, "coords", coords, (None, 2, None, None))
    n, _, h, w = coords.shape
    if len(levels) != LEVELS:
        raise ValueError("%s: %d levels, expected %d"
                         % (op, len(levels), LEVELS))
    for i, vol in enumerate(levels):
        check_cuda_input(op, "level %d" % i, vol, (n * h * w, 1, None, None),
                         coords.device)
    if dtype not in FP32_BF16:
        raise TypeError("%s: the output is float32 or bfloat16, not %s"
                        % (op, dtype))
    out = torch.empty((n, CHANNELS, h, w), dtype=dtype, device=coords.device)
    fn = _build.kernel_fn("upflow_corr_lookup",
                          [PTR] * LEVELS + [INT] * (2 * LEVELS)
                          + [PTR, PTR, INT, INT, INT, INT, PTR])
    dims = [int(d) for vol in levels for d in vol.shape[2:]]
    launch(op, corr_lookup, coords, fn, *(vol.data_ptr() for vol in levels),
           *dims, coords.data_ptr(), out.data_ptr(),
           int(dtype == torch.bfloat16), n, h, w)
    return out


def _corr_lookup(levels, coords, dtype):
    if coords.is_cuda:
        return corr_lookup_cuda(levels, coords, dtype)
    check_cpu_input("corr_lookup", coords)
    return corr_lookup_plain(levels, coords, dtype)


def corr_lookup(levels: Sequence[torch.Tensor], coords: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 324-channel lookup of ``coords`` (N, 2, H, W) fp32 in
    ``levels``, each (N * H * W, 1, h_l, w_l) fp32: the kernel for CUDA
    tensors, the plain version for CPU tensors; (N, 324, H, W) in
    ``dtype``."""
    if wants_grad(coords, *levels):
        raise NotImplementedError("corr_lookup has no gradient rule: RAFT's "
                                  "training is not ported")
    return _corr_lookup(levels, coords, dtype)


corr_lookup.launches = 0
