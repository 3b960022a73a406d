"""Census (ternary) transform ops of the census loss, NCHW.

Port of ``upflow_pytorch_tpu.ops.census``, the internals of the
reference's ``census_loss_torch``:

- grayscale = 0.2989 R + 0.5870 G + 0.1140 B;
- the 7x7 (``max_distance`` 3) neighbourhood minus the centre intensity,
  soft-normalised: ``t / sqrt(0.81 + t^2)``;
- soft Hamming distance: ``sum_k d_k^2 / (0.1 + d_k^2)``.

The patches are shifted slices of the zero-padded intensity image, in
the JAX package's order (dy outer, dx inner).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ternary_transform(image: torch.Tensor,
                      max_distance: int = 3) -> torch.Tensor:
    """(B, 3, H, W) RGB image -> (B, (2d+1)^2, H, W) soft census
    transform."""
    b, c, h, w = image.shape
    if c != 3:
        raise ValueError("ternary_transform needs 3 channels, got %d" % c)
    intensities = (0.2989 * image[:, 0:1] + 0.5870 * image[:, 1:2]
                   + 0.1140 * image[:, 2:3])
    d = max_distance
    pad = F.pad(intensities, (d, d, d, d))
    patches = torch.cat([pad[:, :, dy:dy + h, dx:dx + w]
                         for dy in range(2 * d + 1)
                         for dx in range(2 * d + 1)], dim=1)
    transf = patches - intensities
    return transf / torch.sqrt(0.81 + transf ** 2)


def census_hamming_distance(t1: torch.Tensor,
                            t2: torch.Tensor) -> torch.Tensor:
    """Soft Hamming distance of two census transforms -> (B, 1, H, W)."""
    dist = (t1 - t2) ** 2
    return (dist / (0.1 + dist)).sum(dim=1, keepdim=True)


def census_border_mask(shape_bchw, max_distance: int = 3,
                       dtype=torch.float32, device=None) -> torch.Tensor:
    """Ones with a ``max_distance`` zero border, (1, 1, H, W)."""
    _, _, h, w = shape_bchw
    d = max_distance
    inner = torch.ones((1, 1, h - 2 * d, w - 2 * d), dtype=dtype,
                       device=device)
    return F.pad(inner, (d, d, d, d))
