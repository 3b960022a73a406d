"""Kernel 1: the 81-tap cost-volume correlation (``csrc/correlation.cu``).

Replaces ``upflow_pytorch_tpu/ops/pallas/correlation.py::_corr_fwd_pallas``.
Latency-bound on the H100 at decode level 0, where the main path runs it;
the source note in the ``.cu`` file says how the design meets that.

    out[b, k, y, x] = (1/C) * sum_c f1[b, c, y, x] * f2[b, c, y+dy, x+dx]

with ``k = (dy+D)*(2D+1) + (dx+D)`` and zeros outside ``f2``.  NCHW in,
(B, (2D+1)^2, H, W) out.  The maps are fp32 or bf16 (widened to fp32 as
they are read); the output is fp32.  ``correlation`` launches the kernel for CUDA
tensors and runs ``correlation_plain`` for CPU tensors.

Under autograd (grad mode on, a map requiring grad) ``correlation`` goes
through ``CorrelationFn``: the same forward, and as backward the JAX
package's rule (``correlation.py::_corr_bwd_xla``) in torch ops,
``correlation_vjp``.

The kernel runs the tile body of the normalised correlation
(``csrc/corr_tile.cuh``) without its affine, so both take their grid from
``launch_config`` and their staging route from ``staging_route`` here,
and both are launched by ``launch_tiles``.

On a width-sharded frame the two correlations run on a window of the
frame's columns and are cropped; ``width`` (the frame's width) then
chooses the grid, so that each pixel's channel sum is split as the whole
frame's is and the cropped columns are the whole frame's bit for bit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch import _build
from upflow_pytorch_tpu_torch.ops.kernels._common import (
    FLOAT, FP32_BF16, INT, PTR, SMS, check_cpu_input, check_cuda_input,
    count_cuda_call, launch, wants_grad)
from upflow_pytorch_tpu_torch.utils.profiling import span

KERNEL_DISP = 4  # the kernels' compiled displacement (csrc/corr_tile.cuh)
# the kernel's tiles (rows, columns), tallest then widest first: a block
# has 9 threads for every 4 pixels of a tile row
TILES = ((8, 32), (4, 32), (1, 32), (1, 16))
# blocks of a cluster that split the channels; more than 8 is a
# non-portable cluster size, which the kernel allows for itself
SPLITS = (1, 2, 4, 8, 16)
MIN_THREADS = SMS * 288  # 288 threads an SM on average


def threads_per_block(rows: int, cols: int) -> int:
    return 9 * (cols // 4) * rows


def launch_config(b: int, c: int, h: int, w: int
                  ) -> Tuple[int, int, int, int]:
    """(tile rows, tile columns, channel splits, blocks) of the kernel's
    grid for a (b, c, h, w) map: the fewest splits (a cluster of that many
    blocks per tile, each summing ``channel_ranges(c, splits)``), then the
    first tile of ``TILES``, whose grid gives every SM a block and
    ``MIN_THREADS`` threads in all; else, of the grids that give every SM
    a block if any does, the one with the most threads.  Each split stages
    the halo once more and adds a pass over the tile's partial sums; a
    taller or wider tile stages fewer halo pixels per output pixel; too
    few threads leave the SMs idle."""
    best = None
    for splits in SPLITS:
        if splits > max(c, 1):
            break
        for rows, cols in TILES:
            blocks = b * -(-w // cols) * -(-h // rows) * splits
            threads = blocks * threads_per_block(rows, cols)
            if blocks >= SMS and threads >= MIN_THREADS:
                return rows, cols, splits, blocks
            key = (blocks >= SMS, threads)
            if best is None or key > best[0]:
                best = (key, rows, cols, splits, blocks)
    return best[1:]


def staging_route(w: int, itemsize: int, *data_ptrs: int) -> str:
    """How the kernel stages maps of width ``w`` and ``itemsize`` bytes an
    element: "vec" (4 pixels a copy: 16 bytes of fp32 or 8 of bf16) when
    ``w`` is a multiple of 4 and every map's address a multiple of the
    copy, as on the 384 x 1280 pyramid; "word" (4-byte copies, an edge
    test per pixel) otherwise, as at 375 x 1242's widths 39, 78 and
    311."""
    copy = 4 * itemsize
    ok = w % 4 == 0 and all(p % copy == 0 for p in data_ptrs)
    return "vec" if ok else "word"


def channel_ranges(c: int, splits: int):
    """The channels [start, stop) that each block of a cluster sums, by
    rank, as the kernel computes them; the last ones may be empty."""
    per = -(-c // splits)
    return [(min(c, r * per), min(c, (r + 1) * per)) for r in range(splits)]


def launch_tiles(op: str, wrapper, f1: torch.Tensor, f2: torch.Tensor,
                 out: torch.Tensor, aff: Optional[torch.Tensor] = None,
                 slope: float = 1.0, width: Optional[int] = None) -> None:
    """Launches the tile kernel on checked (B, C, H, W) maps: with ``aff``
    the normalised correlation ``upflow_corr_norm(f1, f2, aff, out, b, c,
    h, w, slope, rows, splits, vec, stream)``, else the plain one
    ``upflow_correlation(f1, f2, out, b, c, h, w, rows, splits, vec,
    stream)`` (``_bf16`` for bf16 maps); counts the launch in
    ``wrapper.launches`` and its route in ``wrapper.route_launches``.  The
    grid is ``launch_config``'s for maps ``width`` columns wide (default
    ``w``): a window of a wider frame takes the frame's channel splits."""
    b, c, h, w = f1.shape
    bf16 = f1.dtype == torch.bfloat16
    if bf16:
        # the kernel stages bf16 maps as aligned 4-byte words
        f1, f2 = (t if t.data_ptr() % 4 == 0 else t.clone() for t in (f1, f2))
    rows, cols, splits, _ = launch_config(b, c, h, w if width is None
                                          else width)
    route = staging_route(w, f1.element_size(), f1.data_ptr(), f2.data_ptr())
    grid = [rows, cols, splits, int(route == "vec")]
    if aff is None:
        fn = _build.kernel_fn("upflow_correlation" + ("_bf16" if bf16 else ""),
                              [PTR, PTR, PTR] + [INT] * 8 + [PTR])
        args = [f1.data_ptr(), f2.data_ptr(), out.data_ptr(), b, c, h, w]
    else:
        fn = _build.kernel_fn("upflow_corr_norm" + ("_bf16" if bf16 else ""),
                              [PTR, PTR, PTR, PTR, INT, INT, INT, INT, FLOAT]
                              + [INT] * 4 + [PTR])
        args = [f1.data_ptr(), f2.data_ptr(), aff.data_ptr(), out.data_ptr(),
                b, c, h, w, slope]
    wrapper.route_launches[route] += 1
    launch(op, wrapper, f1, fn, *args, *grid)


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
                     max_displacement: int = 4,
                     width: Optional[int] = None) -> torch.Tensor:
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
    launch_tiles(op, correlation, f1, f2, out, width=width)
    return out


def _correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int,
                 width: Optional[int] = None) -> torch.Tensor:
    if f1.is_cuda:
        return correlation_cuda(f1, f2, max_displacement, width)
    check_cpu_input("correlation", f1)
    return correlation_plain(f1, f2, max_displacement)


def correlation_vjp(f1: torch.Tensor, f2: torch.Tensor, g: torch.Tensor,
                    max_displacement: int = 4
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(d_f1, d_f2) of the correlation given the cotangent ``g`` of its
    (B, (2D+1)^2, H, W) output: ``_corr_bwd_xla``'s sums over the taps,
    ``d_f1 = (1/C) sum_k g_k * f2(shift k)`` and ``d_f2`` the same products
    of ``f1`` added back at the shifted places (out-of-image taps fall on
    the discarded border), each in its map's type."""
    b, c, h, w = f1.shape
    d = int(max_displacement)
    k = 2 * d + 1
    g = g.float()
    f2_taps = F.unfold(F.pad(f2.float(), (d, d, d, d)), k).reshape(
        b, c, k * k, h, w)
    d_f1 = (g[:, None] * f2_taps).sum(dim=2)
    d_f2 = F.fold((g[:, None] * f1.float()[:, :, None]).reshape(
        b, c * k * k, h * w), (h + 2 * d, w + 2 * d), k)
    inv_c = 1.0 / c
    return ((d_f1 * inv_c).to(f1.dtype),
            (d_f2[:, :, d:d + h, d:d + w] * inv_c).to(f2.dtype))


class CorrelationFn(torch.autograd.Function):
    """``correlation`` with the JAX package's gradient rule."""

    @staticmethod
    def forward(ctx, f1, f2, max_displacement, width):
        ctx.save_for_backward(f1, f2)
        ctx.max_displacement = max_displacement
        return _correlation(f1, f2, max_displacement, width)

    @staticmethod
    def backward(ctx, g):
        with span("upflow.rule.CorrelationFn"):
            f1, f2 = ctx.saved_tensors
            d_f1, d_f2 = correlation_vjp(f1, f2, g, ctx.max_displacement)
            return d_f1, d_f2, None, None


def correlation(f1: torch.Tensor, f2: torch.Tensor, max_displacement: int = 4,
                width: Optional[int] = None) -> torch.Tensor:
    """Cost volume: the kernel for CUDA tensors, the plain version for CPU
    tensors; through ``CorrelationFn`` under autograd.  ``width``: the
    frame's width where the maps are a window of it (``launch_tiles``)."""
    if wants_grad(f1, f2):
        return CorrelationFn.apply(f1, f2, max_displacement, width)
    return _correlation(f1, f2, max_displacement, width)


correlation.launches = 0
correlation.route_launches = {"vec": 0, "word": 0}
