"""Single-head attention within windows: GMFlow's
``transformer.py::single_head_split_window_attention`` (haofeixu/gmflow),
split in three so that one window partition serves the query, key and
value of a merged projection.

- ``to_windows``: tokens (N, H * W, C') of an H x W map, Swin-shifted by
  half a window up and left where ``shifted`` (``torch.roll``), cut into
  ``splits`` x ``splits`` windows by ``split_feature``: (N * splits^2,
  H W / splits^2, C'), window-major within each item;
- ``attend``: softmax(q k^T / sqrt(C) + mask) v in every window, the
  shifted windows under ``shift_window_mask`` (Swin's mask: 0 between
  tokens of one region of the rolled map, -100 between regions);
- ``from_windows``: ``merge_splits`` and the roll back.

Two paths, as for every op of the port: on the card ``attend`` is
``F.scaled_dot_product_attention`` (a library attention, as cuDNN's
convolutions are library convolutions: bf16 operands, fp32 sums and
softmax, one rounding of the output); on the CPU it is ``attend_plain``,
the published matmul, softmax and matmul in fp32 of the operands, rounded
to their dtype.  The mask is a device constant made once per shape
(``ops/resize.py::device_constant``), which a CUDA graph reads by address.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from upflow_pytorch_tpu_torch.ops.resize import device_constant

MASK = -100.0  # Swin's, between tokens of different regions


def split_feature(x: torch.Tensor, splits: int) -> torch.Tensor:
    """``utils.py::split_feature`` (channel last): (B, H, W, C) ->
    (B * splits^2, H / splits, W / splits, C)."""
    b, h, w, c = x.shape
    return x.view(b, splits, h // splits, splits, w // splits, c).permute(
        0, 1, 3, 2, 4, 5).reshape(b * splits * splits, h // splits,
                                  w // splits, c)


def merge_splits(x: torch.Tensor, splits: int) -> torch.Tensor:
    """``utils.py::merge_splits`` (channel last): the inverse of
    ``split_feature``."""
    b, h, w, c = x.shape
    n = b // splits // splits
    return x.view(n, splits, splits, h, w, c).permute(
        0, 1, 3, 2, 4, 5).reshape(n, splits * h, splits * w, c)


def shifts(h: int, w: int, splits: int):
    """The shifted windows' roll: half a window in each direction."""
    return h // splits // 2, w // splits // 2


def to_windows(x: torch.Tensor, h: int, w: int, splits: int,
               shifted: bool) -> torch.Tensor:
    """Tokens (N, H * W, C) of an H x W map -> (N * splits^2, L, C), L =
    H W / splits^2: rolled by (-H / 2 splits, -W / 2 splits) where
    ``shifted``, then cut into windows."""
    n, _, c = x.shape
    x = x.reshape(n, h, w, c)
    if shifted:
        sh, sw = shifts(h, w, splits)
        x = torch.roll(x, shifts=(-sh, -sw), dims=(1, 2))
    return split_feature(x, splits).reshape(n * splits * splits, -1, c)


def from_windows(x: torch.Tensor, h: int, w: int, splits: int,
                 shifted: bool) -> torch.Tensor:
    """The inverse of ``to_windows``: (N * splits^2, L, C) -> (N, H * W,
    C)."""
    c = x.shape[-1]
    x = merge_splits(x.reshape(-1, h // splits, w // splits, c), splits)
    if shifted:
        x = torch.roll(x, shifts=shifts(h, w, splits), dims=(1, 2))
    return x.reshape(x.shape[0], h * w, c)


def shift_window_mask_plain(h: int, w: int, splits: int) -> torch.Tensor:
    """``generate_shift_window_attn_mask`` as published: (splits^2, L, L)
    fp32, 0 between tokens of one region of the rolled map, -100
    between regions."""
    wh, ww = h // splits, w // splits
    sh, sw = shifts(h, w, splits)
    img = torch.zeros((1, h, w, 1))
    cnt = 0
    for hs in (slice(0, -wh), slice(-wh, -sh), slice(-sh, None)):
        for ws in (slice(0, -ww), slice(-ww, -sw), slice(-sw, None)):
            img[:, hs, ws, :] = cnt
            cnt += 1
    win = split_feature(img, splits).view(-1, wh * ww)
    mask = win.unsqueeze(1) - win.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASK).masked_fill(mask == 0, 0.0)


@device_constant(maxsize=16)
def shift_window_mask(h: int, w: int, splits: int, dtype: torch.dtype,
                      device: torch.device) -> torch.Tensor:
    """``shift_window_mask_plain`` in ``dtype`` on ``device``, made once
    (-100 and 0 are exact in bf16)."""
    return shift_window_mask_plain(h, w, splits).to(device=device,
                                                    dtype=dtype)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``single_head_split_window_attention``'s matmul,
    softmax and matmul on (N * W, L, C) windows, W = ``mask``'s first
    dimension, in fp32 of the operands, rounded to ``q``'s dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(
        q.shape[-1])
    if mask is not None:
        m = mask.shape[0]
        scores = (scores.view(-1, m, *scores.shape[1:])
                  + mask.float()).view(scores.shape)
    return torch.matmul(torch.softmax(scores, dim=-1),
                        v.float()).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(C) + mask) v in each window: q, k, v (N * W,
    L, C) (views with the channels contiguous will do), ``mask`` None or
    (W, L, L), the same for every item; (N * W, L, C) in ``q``'s dtype.
    On the card ``F.scaled_dot_product_attention``, on the CPU
    ``attend_plain``."""
    if not q.is_cuda:
        return attend_plain(q, k, v, mask)
    nw, length, c = q.shape
    m = 1 if mask is None else mask.shape[0]
    q4, k4, v4 = (t.view(nw // m, m, length, c) for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=None if mask is None else mask[None],
        scale=1.0 / math.sqrt(c))
    return out.reshape(nw, length, c)
