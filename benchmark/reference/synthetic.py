"""Synthetic frame pairs rendered on the device from a seed.

Each pair is one continuous texture, a random sum of cosine gratings with
wavelengths of 4 to 128 px, seen before and after an affine change of
coordinates (a rotation, a zoom and a shift about the frame's centre), so
the motion is smooth, dense and known:

    im1(p) = T(p),    im2(q) = T(A q + b).

The texture's parameters, the motion and the crop come from numpy's
``default_rng([seed, index])``, so any whole seed, also beyond 32 bits,
gives the same pair on every device; the images are evaluated in fp64 on
``device`` and returned as fp32 NHWC, in the range of the KITTI loader's
normalised images (about +-0.45).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

N_WAVES = 48
AMPLITUDE = 0.45


def _texture(rng: np.random.Generator):
    octaves = rng.uniform(2.0, 7.0, size=(3, N_WAVES))
    wavelength = 2.0 ** octaves
    theta = rng.uniform(0, 2 * np.pi, size=(3, N_WAVES))
    kx = np.cos(theta) * (2 * np.pi / wavelength)
    ky = np.sin(theta) * (2 * np.pi / wavelength)
    phase = rng.uniform(0, 2 * np.pi, size=(3, N_WAVES))
    amp = wavelength / wavelength.sum(axis=1, keepdims=True)
    return kx, ky, phase, amp


def _evaluate(tex, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) fp64 texture at the coordinates ``xs``, ``ys`` (H, W)."""
    kx, ky, phase, amp = tex
    chans = []
    for c in range(3):
        acc = torch.zeros_like(xs)
        for j in range(N_WAVES):
            acc += float(amp[c, j]) * torch.cos(
                float(kx[c, j]) * xs + float(ky[c, j]) * ys
                + float(phase[c, j]))
        chans.append(acc)
    return torch.stack(chans, dim=-1)


def render_pair(seed: int, index: int, raw_hw: Tuple[int, int],
                crop_hw: Tuple[int, int], motion: Dict[str, float],
                device) -> Dict[str, torch.Tensor]:
    """One pair: ``im1_raw``, ``im2_raw`` (Hr, Wr, 3), the crops ``im1``,
    ``im2`` (h, w, 3) and the crop's ``start`` (x, y), fp32 on ``device``.
    ``motion``: ``max_shift`` (px), ``max_rot`` (rad), ``max_zoom``."""
    rng = np.random.default_rng([int(seed), int(index)])
    tex = _texture(rng)
    rh, rw = raw_hw
    ch, cw = crop_hw
    ang = rng.uniform(-motion["max_rot"], motion["max_rot"])
    zoom = 1.0 + rng.uniform(-motion["max_zoom"], motion["max_zoom"])
    ca, sa = np.cos(ang) * zoom, np.sin(ang) * zoom
    a = np.array([[ca, -sa], [sa, ca]])
    centre = np.array([(rw - 1) / 2.0, (rh - 1) / 2.0])
    b = centre - a @ centre + rng.uniform(-motion["max_shift"],
                                          motion["max_shift"], size=2)
    sy = int(rng.integers(0, rh - ch + 1))
    sx = int(rng.integers(0, rw - cw + 1))

    gy, gx = torch.meshgrid(
        torch.arange(rh, dtype=torch.float64, device=device),
        torch.arange(rw, dtype=torch.float64, device=device), indexing="ij")
    im1 = _evaluate(tex, gx, gy)
    im2 = _evaluate(tex, a[0, 0] * gx + a[0, 1] * gy + b[0],
                    a[1, 0] * gx + a[1, 1] * gy + b[1])
    scale = AMPLITUDE / im1.abs().max().clamp_min(1e-6)
    im1, im2 = (im1 * scale).float(), (im2 * scale).float()
    return {"im1_raw": im1, "im2_raw": im2,
            "im1": im1[sy:sy + ch, sx:sx + cw],
            "im2": im2[sy:sy + ch, sx:sx + cw],
            "start": torch.tensor([sx, sy], dtype=torch.float32,
                                  device=device)}


def render(seed: int, indices: Sequence[int], raw_hw: Tuple[int, int],
           crop_hw: Tuple[int, int], motion: Dict[str, float],
           device) -> Dict[str, torch.Tensor]:
    """The pairs ``indices`` of ``seed``, stacked along a batch axis."""
    items = [render_pair(seed, i, raw_hw, crop_hw, motion, device)
             for i in indices]
    return {k: torch.stack([it[k] for it in items]).contiguous()
            for k in items[0]}
