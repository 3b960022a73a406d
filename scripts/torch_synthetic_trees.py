#!/usr/bin/env python3
"""Synthetic KITTI and Sintel directory trees with exact ground truth.

    python3 scripts/torch_synthetic_trees.py --out DIR [--seed 0]

Writes, under DIR, from ``--seed``, the layouts that the datasets of
``upflow_pytorch_tpu_torch/data/kitti.py`` and ``sintel.py`` (and of the
JAX package) read:

- ``data_scene_flow/`` (KITTI 2015): ``training/image_2`` with
  ``PAIRS_PER_SIZE`` pairs at each of KITTI 2015's frame sizes
  (``KITTI_2015_SIZES``), ``flow_occ`` (the exact flow, valid everywhere)
  and ``flow_noc`` (the same flow, valid only where ``p + F(p)`` falls
  inside the frame), both as 16-bit KITTI PNGs; ``testing/image_2`` with
  ``TEST_SIZES``' pairs.
- ``data_stereo_flow/`` (KITTI 2012): one pair in ``training/colored_0``
  with its ``flow_occ`` and ``flow_noc``.
- ``data_scene_flow_multiview/``: a sequence of frames ``_00`` ... ``_20``
  in each of ``training/image_2`` and ``testing/image_2``, one texture
  under a fixed translation of ``MV_MOTION`` px a frame, all at 375x1242
  (the loader stacks raw frames, so one size).
- Sintel: ``training/{clean,final}/<scene>/frame_%04d.png``,
  ``training/flow/<scene>/frame_%04d.flo`` and
  ``training/occlusions/<scene>/frame_%04d.png`` (255 where ``p + F(p)``
  leaves the frame), ``SINTEL_SCENES`` scenes of ``SINTEL_FRAMES`` frames
  at 436x1024 under a fixed small affine motion; the final pass is the
  clean one with seeded noise of +-3 levels.

Frames are the analytic textures of ``data/synthetic.py`` stored as the
uint8 that ``normalize_image`` maps back to the texture (clipped to
[0, 255]); the pairs' flow is known in closed form (``make_pair``), so
the ground truth is exact up to the KITTI PNG's 1/64 px.  Only numpy, the
port's codecs and ``data/synthetic.py`` are used; the frames are rendered
in threads.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from upflow_pytorch_tpu_torch.data import synthetic  # noqa: E402
from upflow_pytorch_tpu_torch.data.flow_io import (  # noqa: E402
    write_flo, write_flow_png, write_png)
from upflow_pytorch_tpu_torch.data.image_io import (  # noqa: E402
    UNFLOW_MEAN, UNFLOW_SCALE)

KITTI_2015_SIZES = ((375, 1242), (376, 1241), (370, 1224), (374, 1238))
PAIRS_PER_SIZE = 2
TEST_SIZES = ((375, 1242), (374, 1238))
KITTI_2012_SIZE = (375, 1242)
MV_SIZE, MV_FRAMES, MV_MOTION = (375, 1242), 21, (2, 1)  # (dx, dy) px
SINTEL_SIZE, SINTEL_SCENES, SINTEL_FRAMES = (436, 1024), 2, 3
SINTEL_MOTION = dict(max_shift=4.0, max_rot=0.008, max_zoom=0.01)


def to_uint8(texture: np.ndarray) -> np.ndarray:
    """The uint8 RGB frame that ``normalize_image`` maps back to
    ``texture`` (rounded, clipped)."""
    return np.clip(np.rint(texture / UNFLOW_SCALE + UNFLOW_MEAN), 0,
                   255).astype(np.uint8)


def in_frame(flow: np.ndarray) -> np.ndarray:
    """(H, W) bool: where ``p + F(p)`` falls inside the frame."""
    h, w = flow.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w]
    x, y = xs + flow[..., 0], ys + flow[..., 1]
    return (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)


def _kitti_pair(image_dir: str, flow_dir: Optional[str], index: int,
                seed: int, hw: Tuple[int, int]) -> None:
    p = synthetic.make_pair(seed, raw_hw=hw, crop_hw=hw)
    write_png(os.path.join(image_dir, "%06d_10.png" % index),
              to_uint8(p["im1_raw"]))
    write_png(os.path.join(image_dir, "%06d_11.png" % index),
              to_uint8(p["im2_raw"]))
    if flow_dir is None:
        return
    flow = p["gt_flow"]
    name = "%06d_10.png" % index
    write_flow_png(os.path.join(flow_dir, "flow_occ", name), flow)
    write_flow_png(os.path.join(flow_dir, "flow_noc", name), flow,
                   in_frame(flow).astype(np.uint16))


def _texture(seed: int, xs: np.ndarray, ys: np.ndarray) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return synthetic._eval_texture(synthetic._texture_params(rng), xs, ys)


def _multiview_sequence(image_dir: str, index: int, seed: int) -> None:
    """Frames ``_00`` .. ``_20`` of one texture, each shifted by
    ``MV_MOTION`` from the last: crops of one rendered canvas."""
    (h, w), (dx, dy) = MV_SIZE, MV_MOTION
    span = MV_FRAMES - 1
    ys, xs = np.mgrid[0:h + span * dy, 0:w + span * dx].astype(np.float64)
    canvas = to_uint8(_texture(seed, xs, ys))
    for t in range(MV_FRAMES):
        write_png(os.path.join(image_dir, "%06d_%02d.png" % (index, t)),
                  canvas[t * dy:t * dy + h, t * dx:t * dx + w])


def _sintel_scene(root: str, scene: str, seed: int) -> None:
    """``SINTEL_FRAMES`` frames ``frame_t(q) = T(G_t q)`` with ``G_t`` the
    t-th power of one affine map; flow t -> t+1 is
    ``G_{t+1}^-1(G_t p) - p``."""
    rng = np.random.RandomState(seed)
    h, w = SINTEL_SIZE
    params = synthetic._texture_params(rng)
    ang = rng.uniform(-SINTEL_MOTION["max_rot"], SINTEL_MOTION["max_rot"])
    zoom = 1.0 + rng.uniform(-SINTEL_MOTION["max_zoom"],
                             SINTEL_MOTION["max_zoom"])
    ca, sa = np.cos(ang) * zoom, np.sin(ang) * zoom
    step = np.array([[ca, -sa, 0.0], [sa, ca, 0.0], [0.0, 0.0, 1.0]])
    center = np.array([(w - 1) / 2.0, (h - 1) / 2.0])
    step[:2, 2] = (center - step[:2, :2] @ center
                   + rng.uniform(-SINTEL_MOTION["max_shift"],
                                 SINTEL_MOTION["max_shift"], size=2))
    noise = np.random.RandomState(seed + 1)
    gy, gx = np.mgrid[0:h, 0:w].astype(np.float64)
    dirs = {sub: os.path.join(root, "training", sub, scene)
            for sub in ("clean", "final", "flow", "occlusions")}
    maps = [np.linalg.matrix_power(step, t) for t in range(SINTEL_FRAMES)]
    for t, g in enumerate(maps):
        qx = g[0, 0] * gx + g[0, 1] * gy + g[0, 2]
        qy = g[1, 0] * gx + g[1, 1] * gy + g[1, 2]
        clean = to_uint8(synthetic._eval_texture(params, qx, qy))
        final = np.clip(clean.astype(np.int16)
                        + noise.randint(-3, 4, clean.shape), 0,
                        255).astype(np.uint8)
        name = "frame_%04d" % (t + 1)
        write_png(os.path.join(dirs["clean"], name + ".png"), clean)
        write_png(os.path.join(dirs["final"], name + ".png"), final)
        if t + 1 == SINTEL_FRAMES:
            continue
        m = np.linalg.inv(maps[t + 1]) @ g
        fx = m[0, 0] * gx + m[0, 1] * gy + m[0, 2] - gx
        fy = m[1, 0] * gx + m[1, 1] * gy + m[1, 2] - gy
        flow = np.stack([fx, fy], axis=-1).astype(np.float32)
        write_flo(os.path.join(dirs["flow"], name + ".flo"), flow)
        write_png(os.path.join(dirs["occlusions"], name + ".png"),
                  np.where(in_frame(flow), 0, 255).astype(np.uint8))


def write_trees(root: str, seed: int = 0, workers: int = 8
                ) -> Dict[str, List[Tuple[int, int]]]:
    """Writes the four trees under ``root``; returns the frame sizes of
    each KITTI eval split, in file order."""
    jobs = []
    splits: Dict[str, List[Tuple[int, int]]] = {}

    def kitti(base, split, image_sub, sizes, with_gt, seed_base):
        d = os.path.join(root, base, split)
        os.makedirs(os.path.join(d, image_sub), exist_ok=True)
        if with_gt:
            for sub in ("flow_occ", "flow_noc"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
        for i, hw in enumerate(sizes):
            jobs.append((_kitti_pair, os.path.join(d, image_sub),
                         d if with_gt else None, i, seed_base + i, hw))
        return list(sizes)

    sizes = [hw for hw in KITTI_2015_SIZES for _ in range(PAIRS_PER_SIZE)]
    splits["2015_train"] = kitti("data_scene_flow", "training", "image_2",
                                 sizes, True, seed * 1000)
    splits["2015_test"] = kitti("data_scene_flow", "testing", "image_2",
                                TEST_SIZES, False, seed * 1000 + 100)
    splits["2012_train"] = kitti("data_stereo_flow", "training",
                                 "colored_0", [KITTI_2012_SIZE], True,
                                 seed * 1000 + 200)
    for i, split in enumerate(("training", "testing")):
        d = os.path.join(root, "data_scene_flow_multiview", split,
                         "image_2")
        os.makedirs(d, exist_ok=True)
        jobs.append((_multiview_sequence, d, i, seed * 1000 + 300 + i))
    for s in range(SINTEL_SCENES):
        scene = "scene_%d" % s
        for sub in ("clean", "final", "flow", "occlusions"):
            os.makedirs(os.path.join(root, "training", sub, scene),
                        exist_ok=True)
        jobs.append((_sintel_scene, root, scene, seed * 1000 + 400 + s))
    with ThreadPoolExecutor(max_workers=workers) as ex:
        for f in [ex.submit(fn, *args) for fn, *args in jobs]:
            f.result()
    return splits


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args(argv)
    splits = write_trees(args.out, args.seed, args.workers)
    for name, sizes in splits.items():
        print("%s: %d pairs %s" % (name, len(sizes), sizes))
    return 0


if __name__ == "__main__":
    sys.exit(main())
