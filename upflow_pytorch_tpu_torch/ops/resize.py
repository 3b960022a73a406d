"""Bilinear resize with ``align_corners=True`` semantics, and the area
downsample of the smoothness loss, NCHW.

The reference resizes with ``F.interpolate(..., align_corners=True)`` at
every pyramid level (``upsample2d_as`` / ``upsample2d_flow_as`` /
``upsample_flow``).  Here the separable interpolation is two fp32
products with the (out, in) interpolation matrices that the JAX package
uses, so both packages give the same numbers; ``downsample_area`` is the
same with the area-pool matrices.  ``resize_vjp`` is the transposed
product, the resize's gradient, for the backward rules of the kernels
that resize inside them.

The bilinear resizes take ``cols`` (``ops/columns.py::Columns``) for
a map whose width is sharded: the input is this rank's columns of a map
``cols.width`` wide, the output this rank's columns of the resized map,
from the rows ``[lo, hi)`` of the global column matrix over the input
window their taps reach.

The interpolation and pool matrices are device constants, made once per
size and device and kept in bounded caches.  A CUDA graph reads them by
address, so ``keeping_constants`` lists the ones a capture looks up and
its owner holds them after the caches evict them.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch


@contextlib.contextmanager
def full_fp32_matmuls() -> Iterator[None]:
    """Pins full-fp32 matrix products (no TF32) for the block, as the JAX
    package pins ``Precision.HIGHEST`` for its resizes, and restores the
    caller's setting after it.  Torch keeps the setting through two linked
    APIs: ``torch.set_float32_matmul_precision`` (and ``allow_tf32``), and
    the per-backend ``torch.backends.cuda.matmul.fp32_precision``; once a
    caller has used the latter, the former's getter raises.  The setting
    is pinned and restored through the API the caller used, and left
    untouched where it already asks for full fp32."""
    matmul = torch.backends.cuda.matmul
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the caller set the per-backend API
        legacy = None
    if legacy == "highest" or (legacy is None
                               and matmul.fp32_precision == "ieee"):
        yield
        return
    if legacy is None:
        saved = matmul.fp32_precision
        matmul.fp32_precision = "ieee"
    else:
        torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        if legacy is None:
            matmul.fp32_precision = saved
        else:
            torch.set_float32_matmul_precision(legacy)


@contextlib.contextmanager
def fp32_numerics() -> Iterator[None]:
    """fp32 convolutions and matrix products (the flow resizes) in full
    fp32 for the block: cuDNN's TF32 switched off and the matrix products'
    precision pinned (``full_fp32_matmuls``), whatever the caller set, and
    both restored after it."""
    cudnn = torch.backends.cudnn
    with full_fp32_matmuls(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        yield


@functools.lru_cache(maxsize=256)
def _interp_matrix_np(out_size: int, in_size: int) -> np.ndarray:
    """(out_size, in_size) align_corners=True bilinear interpolation matrix."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == 1:
        m[:, 0] = 1.0
        return m
    if out_size == 1:
        # align_corners=True with a single output sample reads index 0
        m[0, 0] = 1.0
        return m
    scale = (in_size - 1) / (out_size - 1)
    src = np.arange(out_size, dtype=np.float64) * scale
    i0 = np.floor(src).astype(np.int64)
    i0 = np.clip(i0, 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    w0 = 1.0 - w1
    rows = np.arange(out_size)
    np.add.at(m, (rows, i0), w0)
    np.add.at(m, (rows, i1), w1)
    return m


_kept: Optional[List[object]] = None  # the list of ``keeping_constants``


def device_constant(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that makes a
    constant on a device; inside ``keeping_constants`` each lookup is also
    appended to its list."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args):
            out = cached(*args)
            if _kept is not None:
                _kept.append(out)
            return out
        return get
    return wrap


@contextlib.contextmanager
def keeping_constants() -> Iterator[List[object]]:
    """Yields a list that receives every device constant looked up in the
    block (the interpolation and pool matrices, the taps, and the other
    modules' ``device_constant``s: GMFlow's window mask, position code and
    grid)."""
    global _kept
    saved, _kept = _kept, []
    try:
        yield _kept
    finally:
        _kept = saved


@device_constant(maxsize=256)
def _interp_matrix(out_size: int, in_size: int,
                   device: torch.device) -> torch.Tensor:
    """The matrix on ``device``, kept after its first use: a copy from host
    memory on every call would make the host wait for the device each
    time.  Callers only read it."""
    return torch.from_numpy(_interp_matrix_np(out_size, in_size)).to(device)


@device_constant(maxsize=64)
def interp_taps(out_size: int, in_size: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nonzero entries of each row of ``_interp_matrix_np(out_size,
    in_size)``, for kernels that lerp instead of multiplying by the matrix:
    (out_size, 2) int32 source indices and (out_size, 2) fp32 weights, on
    ``device`` and kept there.  A row with one nonzero entry repeats its
    index with weight 0."""
    m = _interp_matrix_np(out_size, in_size)
    nonzero = m != 0
    rows = np.arange(out_size)
    first = nonzero.argmax(axis=1)
    last = in_size - 1 - nonzero[:, ::-1].argmax(axis=1)
    idx = np.stack([first, last], axis=1).astype(np.int32)
    wt = np.stack([m[rows, first],
                   np.where(last != first, m[rows, last], 0.0)],
                  axis=1).astype(np.float32)
    return (torch.from_numpy(idx).to(device),
            torch.from_numpy(wt).to(device))


def _separable(x: torch.Tensor, out_hw, matrix, cols=None) -> torch.Tensor:
    """``x`` (B, C, H, W) times ``matrix(oh, h, device)`` along the rows,
    then ``matrix(ow, w, device)`` along the columns, in fp32, cast back to
    ``x``'s type.  With ``cols`` (bilinear only), ``x`` is this rank's
    columns of a map ``cols.width`` wide, and the column product takes
    the rank's rows of the global matrix over the input columns they
    reach (``_reach``)."""
    _, _, h, w = x.shape
    if cols is not None:
        w = cols.width
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if (oh, ow) == (h, w):
        return x
    xf = x.float()
    if oh != h:
        xf = torch.einsum("oh,bchw->bcow", matrix(oh, h, x.device), xf)
    if ow != w:
        m = matrix(ow, w, x.device)
        if cols is not None:
            spans = cols.spans_of(ow)
            reach = [_reach(ow, w, lo, hi) for lo, hi in spans]
            xf = cols.window(xf, lambda r: reach[r], "clip")
            (lo, hi), (a, b) = spans[cols.rank], reach[cols.rank]
            m = m[lo:hi, a:b]
        xf = torch.einsum("ow,bchw->bcho", m, xf)
    return xf.to(x.dtype)


@functools.lru_cache(maxsize=256)
def _reach(out_size: int, in_size: int, lo: int, hi: int
           ) -> Tuple[int, int]:
    """The input columns ``[a, b)`` that the rows ``[lo, hi)`` of the
    (out_size, in_size) interpolation matrix read: the matrix is monotone,
    so the first nonzero of row ``lo`` and the last of row ``hi - 1``
    bound them."""
    m = _interp_matrix_np(out_size, in_size)
    return (int(np.flatnonzero(m[lo])[0]),
            int(np.flatnonzero(m[hi - 1])[-1]) + 1)


def resize_bilinear_align_corners(x: torch.Tensor, out_hw: Tuple[int, int],
                                  cols=None) -> torch.Tensor:
    """Resize NCHW ``x`` to ``out_hw`` (align_corners=True bilinear).  With
    ``cols``, ``x`` is this rank's columns of a map ``cols.width`` wide and
    the result this rank's columns of the resized map."""
    return _separable(x, out_hw, _interp_matrix, cols)


def resize_vjp(g: torch.Tensor, in_hw: Tuple[int, int]) -> torch.Tensor:
    """The gradient of ``resize_bilinear_align_corners`` from an input of
    size ``in_hw``, given the cotangent ``g`` of its fp32 output: the
    transposed products, in the reverse order."""
    _, _, oh, ow = g.shape
    h, w = int(in_hw[0]), int(in_hw[1])
    gf = g.float()
    if ow != w:
        gf = torch.einsum("ow,bcho->bchw", _interp_matrix(ow, w, g.device), gf)
    if oh != h:
        gf = torch.einsum("oh,bcow->bchw", _interp_matrix(oh, h, g.device), gf)
    return gf


@device_constant(maxsize=64)
def _pool_matrix(out_size: int, in_size: int,
                 device: torch.device) -> torch.Tensor:
    """(out_size, in_size) area-pool matrix on ``device``, kept there: bin
    ``o`` averages the inputs [floor(o*in/out), ceil((o+1)*in/out))."""
    m = np.zeros((out_size, in_size), dtype=np.float32)
    for o in range(out_size):
        lo = (o * in_size) // out_size
        hi = -(-((o + 1) * in_size) // out_size)
        m[o, lo:hi] = 1.0 / (hi - lo)
    return torch.from_numpy(m).to(device)


def downsample_area(x: torch.Tensor, out_hw) -> torch.Tensor:
    """``F.interpolate(mode='area')`` (adaptive average pooling) of NCHW
    ``x`` to ``out_hw``, as two fp32 matrix products: the '1/4' smoothness
    level's image downsample."""
    return _separable(x, out_hw, _pool_matrix)


def upsample2d_as(x: torch.Tensor, target_hw) -> torch.Tensor:
    """``upsample2d_as``: resize to the target's (H, W)."""
    return resize_bilinear_align_corners(x, target_hw)


def upsample2d_flow_as(flow: torch.Tensor, target_hw, if_rate: bool = False,
                       cols=None) -> torch.Tensor:
    """``upsample2d_flow_as`` on a (B, 2, H, W) flow.  With ``if_rate`` the
    resized u is scaled by ``out_w / in_w`` and v by ``out_h / in_h``, the
    frame's widths: with ``cols`` the flow is this rank's columns of a
    flow ``cols.width`` wide (``resize_bilinear_align_corners``)."""
    _, c, h, w = flow.shape
    if c != 2:
        raise ValueError("flow must have 2 channels (u, v), got %d" % c)
    res = resize_bilinear_align_corners(flow, target_hw, cols)
    if if_rate:
        if cols is not None:
            w = cols.width
        oh, ow = int(target_hw[0]), int(target_hw[1])
        # the scales go to the kernels as arguments, not as a tensor
        # copied from the host
        res = torch.stack([res[:, 0] * (ow / w), res[:, 1] * (oh / h)], dim=1)
    return res


def upsample_flow(flow: torch.Tensor, target_hw) -> torch.Tensor:
    """``upsample_flow``: always rate-scaled."""
    return upsample2d_flow_as(flow, target_hw, if_rate=True)
