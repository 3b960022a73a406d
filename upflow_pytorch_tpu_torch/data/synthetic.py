"""Synthetic image pairs with exactly-known ground-truth flow.

Port of ``upflow_pytorch_tpu/data/synthetic.py`` in numpy, operation for
operation, so the same seeds give the same arrays (the tests hold them
equal).  The reference has no quality gate but the KITTI benchmark; this
module builds one: image pairs rendered from one CONTINUOUS analytic
texture under an affine change of coordinates, so the forward flow
between them is known in closed form with zero resampling error:

    im1(p) = T(p)
    im2(q) = T(A q + b)          (affine backward map)
    =>  correspondence p = A q + b, i.e. forward flow
        F(p) = A^{-1}(p - b) - p   exactly.

T is a random sum of cosine gratings (a band-limited "fractal" texture
with energy at octave-spaced frequencies), analytically evaluable at any
real coordinate: no source-image interpolation enters the ground truth.

Pairs come in the training batch layout of the KITTI multiview loader:
full 'raw' images plus a crop and its ``start`` offset.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# image normalization scale matching the KITTI loader's
# (img - mean) * 0.0039216 range (kitti_dataset.py:45-54 semantics)
_AMPLITUDE = 0.45


def _texture_params(rng: np.random.RandomState, n_waves: int = 48):
    """Random cosine-grating mixture: per channel, n_waves components with
    octave-spread spatial frequencies (wavelengths ~4..128 px)."""
    octaves = rng.uniform(2.0, 7.0, size=(3, n_waves))  # log2 wavelength
    wavelength = 2.0 ** octaves
    theta = rng.uniform(0, 2 * np.pi, size=(3, n_waves))
    kx = np.cos(theta) * (2 * np.pi / wavelength)
    ky = np.sin(theta) * (2 * np.pi / wavelength)
    phase = rng.uniform(0, 2 * np.pi, size=(3, n_waves))
    # 1/f-ish amplitude so coarse structure dominates but fine detail exists
    amp = wavelength / wavelength.sum(axis=1, keepdims=True)
    return kx, ky, phase, amp


def _eval_texture(params, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    """Evaluate the texture at real coordinates.  xs, ys: (H, W)."""
    kx, ky, phase, amp = params
    h, w = xs.shape
    out = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        acc = np.zeros((h, w), np.float64)
        for j in range(kx.shape[1]):
            acc += amp[c, j] * np.cos(kx[c, j] * xs + ky[c, j] * ys
                                      + phase[c, j])
        out[..., c] = acc
    # normalize each channel to ~[-_AMPLITUDE, _AMPLITUDE]
    out = out / max(np.abs(out).max(), 1e-6) * _AMPLITUDE
    return out.astype(np.float32)


def make_pair(seed: int,
              raw_hw: Tuple[int, int] = (160, 352),
              crop_hw: Tuple[int, int] = (128, 320),
              max_shift: float = 4.0,
              max_rot: float = 0.008,
              max_zoom: float = 0.01) -> Dict[str, np.ndarray]:
    """One synthetic training item with exact GT flow on the crop.

    Returns im1_raw/im2_raw (raw_hw), im1/im2 (crop_hw), start (2,),
    gt_flow (crop_hw + (2,)) — the forward flow on the crop, exact.
    """
    rng = np.random.RandomState(seed)
    tex = _texture_params(rng)
    rh, rw = raw_hw
    ch, cw = crop_hw

    # affine backward map q -> A q + b about the raw-image center
    ang = rng.uniform(-max_rot, max_rot)
    zoom = 1.0 + rng.uniform(-max_zoom, max_zoom)
    ca, sa = np.cos(ang) * zoom, np.sin(ang) * zoom
    A = np.array([[ca, -sa], [sa, ca]], np.float64)
    center = np.array([(rw - 1) / 2.0, (rh - 1) / 2.0])
    shift = rng.uniform(-max_shift, max_shift, size=2)
    b = center - A @ center + shift

    gy, gx = np.mgrid[0:rh, 0:rw].astype(np.float64)
    im1_raw = _eval_texture(tex, gx, gy)
    qx = A[0, 0] * gx + A[0, 1] * gy + b[0]
    qy = A[1, 0] * gx + A[1, 1] * gy + b[1]
    im2_raw = _eval_texture(tex, qx, qy)

    # crop with a margin (the 'start point' the boundary warp consumes)
    sy = rng.randint(0, rh - ch + 1)
    sx = rng.randint(0, rw - cw + 1)
    im1 = im1_raw[sy:sy + ch, sx:sx + cw]
    im2 = im2_raw[sy:sy + ch, sx:sx + cw]

    # exact forward flow on im1's crop grid: F(p) = A^{-1}(p - b) - p
    Ainv = np.linalg.inv(A)
    py, px = np.mgrid[sy:sy + ch, sx:sx + cw].astype(np.float64)
    fx = Ainv[0, 0] * (px - b[0]) + Ainv[0, 1] * (py - b[1]) - px
    fy = Ainv[1, 0] * (px - b[0]) + Ainv[1, 1] * (py - b[1]) - py
    gt = np.stack([fx, fy], axis=-1).astype(np.float32)

    return {
        "im1_raw": im1_raw,
        "im2_raw": im2_raw,
        "im1": im1,
        "im2": im2,
        "start": np.array([sx, sy], np.float32),
        "gt_flow": gt,
    }


def make_dataset(n_pairs: int, seed: int = 0, **kw) -> Dict[str, np.ndarray]:
    """Stacked batch dict of ``n_pairs`` items (keys as in make_pair)."""
    items = [make_pair(seed * 1000 + i, **kw) for i in range(n_pairs)]
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def epe(pred_flow: np.ndarray, gt_flow: np.ndarray,
        border: int = 8) -> float:
    """Mean endpoint error, excluding a border margin (the analytic
    occlusion/photometric signals degrade at crop borders)."""
    d = np.linalg.norm(np.asarray(pred_flow, np.float32) - gt_flow, axis=-1)
    if border:
        d = d[:, border:-border, border:-border]
    return float(d.mean())
