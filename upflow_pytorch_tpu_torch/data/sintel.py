"""MPI-Sintel datasets.

Port of ``upflow_pytorch_tpu/data/sintel.py``.  The reference trains and
evaluates on KITTI only; the UPFlow paper also fine-tunes on Sintel, and
these loaders give the two views the KITTI datasets give:

- ``SintelEvalDataset``: (im1, im2, flow GT, valid, occlusion mask) eval
  samples for ``eval.bench.EvaluationBench`` (flow GT from Middlebury
  .flo; all-ones valid; EPE-noc from the ``occlusions`` masks when
  present).
- ``SintelTrainDataset``: unlabeled consecutive-frame pairs with the
  random crop + ``start`` offset of boundary-dilated warping (the item
  structure of ``KittiMultiviewDataset``).

Standard layout: <root>/training/{clean,final}/<scene>/frame_%04d.png,
<root>/training/flow/<scene>/frame_%04d.flo,
<root>/training/occlusions/<scene>/frame_%04d.png.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from upflow_pytorch_tpu_torch.data.flow_io import read_flo
from upflow_pytorch_tpu_torch.data.image_io import normalize_image, read_image
from upflow_pytorch_tpu_torch.data.rng import item_rng
from upflow_pytorch_tpu_torch.eval.bench import EvalSample


def scan_sintel(root: str, split: str = "training", render: str = "final",
                with_flow: bool = True) -> List[Dict[str, Optional[str]]]:
    img_root = os.path.join(root, split, render)
    flow_root = os.path.join(root, split, "flow")
    occ_root = os.path.join(root, split, "occlusions")
    items: List[Dict[str, Optional[str]]] = []
    for scene in sorted(os.listdir(img_root)):
        sdir = os.path.join(img_root, scene)
        frames = sorted(os.listdir(sdir))
        for a, b in zip(frames[:-1], frames[1:]):
            item: Dict[str, Optional[str]] = {
                "im1": os.path.join(sdir, a),
                "im2": os.path.join(sdir, b),
                "flow": None,
                "occ": None,
            }
            if with_flow:
                flo = os.path.join(flow_root, scene,
                                   a.replace(".png", ".flo"))
                if os.path.isfile(flo):
                    item["flow"] = flo
                occ = os.path.join(occ_root, scene, a)
                if os.path.isfile(occ):
                    item["occ"] = occ
            items.append(item)
    return items


class SintelEvalDataset:
    """Batch-1 EvalSamples; 'noc' view masks out the occlusion pixels."""

    def __init__(self, root: str, render: str = "final",
                 normalize: bool = True):
        self.items = [it for it in scan_sintel(root, "training", render)
                      if it["flow"] is not None]
        self.normalize = normalize

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> EvalSample:
        it = self.items[index]
        im1 = normalize_image(read_image(it["im1"]), self.normalize)[None]
        im2 = normalize_image(read_image(it["im2"]), self.normalize)[None]
        flow = read_flo(it["flow"])[None]
        h, w = flow.shape[1:3]
        valid = np.ones((1, h, w, 1), np.float32)
        if it["occ"] is not None:
            occ_img = read_image(it["occ"])  # white = occluded
            noc = (occ_img[..., 0] < 128).astype(np.float32)[None, ..., None]
        else:
            noc = valid
        return EvalSample(im1=im1, im2=im2, flow_occ=flow, mask_occ=valid,
                          flow_noc=flow.copy(), mask_noc=noc,
                          name=os.path.basename(it["im1"]).replace(".png", ""))

    def __iter__(self) -> Iterator[EvalSample]:
        for i in range(len(self)):
            yield self[i]


class SintelTrainDataset:
    """Unsupervised training pairs with crop + start offset."""

    def __init__(self, root: str, render: str = "final",
                 crop_size: Tuple[int, int] = (384, 768), rho: int = 8,
                 swap_images: bool = True, normalize: bool = True,
                 horizontal_flip_aug: bool = True, seed: int = 0):
        self.items = scan_sintel(root, "training", render, with_flow=False)
        self.crop_size = crop_size
        self.rho = rho
        self.swap_images = swap_images
        self.normalize = normalize
        self.horizontal_flip_aug = horizontal_flip_aug
        self.seed = seed

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.item(index, epoch=0)

    def item(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        """Stateless per-item augmentation (see data/rng.py)."""
        rng = item_rng(self.seed, epoch, index)
        it = self.items[index]
        flip = self.horizontal_flip_aug and rng.random() < 0.5
        im1 = normalize_image(read_image(it["im1"]), self.normalize, flip)
        im2 = normalize_image(read_image(it["im2"]), self.normalize, flip)
        if self.swap_images and rng.random() < 0.5:
            im1, im2 = im2, im1
        h, w = im1.shape[:2]
        ph, pw = self.crop_size
        ph, pw = min(ph, h - 2 * self.rho - 1), min(pw, w - 2 * self.rho - 1)
        x = int(rng.integers(self.rho, w - self.rho - pw))
        y = int(rng.integers(self.rho, h - self.rho - ph))
        return {
            "im1_raw": im1,
            "im2_raw": im2,
            "im1": im1[y:y + ph, x:x + pw],
            "im2": im2[y:y + ph, x:x + pw],
            "start": np.array([x, y], np.float32),
        }
