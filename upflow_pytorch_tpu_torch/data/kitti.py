"""KITTI datasets.

Port of ``upflow_pytorch_tpu/data/kitti.py``, the re-design of the
reference's dataset layer (``dataset/kitti_dataset.py``):

- ``KittiFlowEvalDataset``   <- ``kitti_flow.kitti_train`` (:575-631) +
  ``kitti_flow.get_file_names`` (:516-573): the 2012/2015 train/test eval
  splits with flow_occ / flow_noc GT.
- ``KittiMultiviewDataset``  <- ``kitti_train.kitti_data_with_start_point``
  (:268-376) + ``mv_data_get_file_names`` (:194-266): the unlabeled
  multiview training pairs, excluding GT-adjacent frames 9-12, with random
  crop + crop-offset ``start`` for boundary-dilated warping, horizontal-flip
  and image-order-swap augmentation.

There are no hard-coded data roots: pass ``root``.  Arrays are NHWC
float32 numpy on the host; the evaluation model and the loader move them
to the card.  Each item draws its augmentation from ``data/rng.py::
item_rng`` in the JAX order (flip, swap, x, y), so the same ``(seed,
epoch, index)`` gives the same crop in both packages.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from upflow_pytorch_tpu_torch.data import native
from upflow_pytorch_tpu_torch.data import flow_io
from upflow_pytorch_tpu_torch.data.image_io import normalize_image, read_image
from upflow_pytorch_tpu_torch.data.rng import item_rng
from upflow_pytorch_tpu_torch.eval.bench import EvalSample


def read_flow_png(path):
    """KITTI flow PNG through the native C++ decoder, else the Python
    codec."""
    if native.available():
        return native.decode_flow_png(path)
    return flow_io.read_flow_png(path)


# --------------------------------------------------------------------------
# eval splits
# --------------------------------------------------------------------------

_EVAL_LAYOUT = {
    # name -> (base dir, image subdir, has ground truth)
    "2012_train": ("data_stereo_flow", "training", "colored_0", True),
    "2015_train": ("data_scene_flow", "training", "image_2", True),
    "2012_test": ("data_stereo_flow", "testing", "colored_0", False),
    "2015_test": ("data_scene_flow", "testing", "image_2", False),
}


def scan_eval_files(root: str, name: str) -> List[Dict[str, str]]:
    """List eval items as dicts of file paths (kitti_dataset.py:516-573)."""
    base, split, img_sub, has_gt = _EVAL_LAYOUT[name]
    image_dir = os.path.join(root, base, split, img_sub)
    image_files = sorted(os.listdir(image_dir))
    if len(image_files) % 2:
        raise ValueError("expected pairs of images in %s" % image_dir)
    items = []
    if has_gt:
        occ_dir = os.path.join(root, base, split, "flow_occ")
        noc_dir = os.path.join(root, base, split, "flow_noc")
        occ_files = sorted(os.listdir(occ_dir))
        noc_files = sorted(os.listdir(noc_dir))
        if not len(occ_files) == len(noc_files) == len(image_files) // 2:
            raise ValueError("%s: %d image pairs, %d flow_occ and %d flow_noc "
                             "files" % (name, len(image_files) // 2,
                                        len(occ_files), len(noc_files)))
        for i in range(len(image_files) // 2):
            items.append({
                "im1": os.path.join(image_dir, image_files[2 * i]),
                "im2": os.path.join(image_dir, image_files[2 * i + 1]),
                "flow_occ": os.path.join(occ_dir, occ_files[i]),
                "flow_noc": os.path.join(noc_dir, noc_files[i]),
            })
    else:
        for i in range(len(image_files) // 2):
            items.append({
                "im1": os.path.join(image_dir, image_files[2 * i]),
                "im2": os.path.join(image_dir, image_files[2 * i + 1]),
            })
    return items


class KittiFlowEvalDataset:
    """Iterable of batch-1 ``EvalSample``s at native image size.

    (The reference computes a 32-multiple center crop but never applies it —
    kitti_dataset.py:612-617 — eval runs at native resolution; the model pads
    internally via its pyramid and resizes flow back.)
    """

    def __init__(self, root: str, name: str = "2015_train",
                 normalize: bool = True):
        if name not in _EVAL_LAYOUT:
            raise ValueError("unknown KITTI split %r (one of %s)"
                             % (name, ", ".join(_EVAL_LAYOUT)))
        self.name = name
        self.has_gt = _EVAL_LAYOUT[name][3]
        self.items = scan_eval_files(root, name)
        self.normalize = normalize

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index: int) -> EvalSample:
        it = self.items[index]
        im1 = normalize_image(read_image(it["im1"]), self.normalize)[None]
        im2 = normalize_image(read_image(it["im2"]), self.normalize)[None]
        name = os.path.basename(it["im1"]).replace(".png", "")
        if not self.has_gt:
            return EvalSample(im1=im1, im2=im2, name=name)
        occ, occ_mask = read_flow_png(it["flow_occ"])
        noc, noc_mask = read_flow_png(it["flow_noc"])
        return EvalSample(
            im1=im1, im2=im2,
            flow_occ=occ[None], mask_occ=occ_mask[None].astype(np.float32),
            flow_noc=noc[None], mask_noc=noc_mask[None].astype(np.float32),
            name=name)

    def __iter__(self) -> Iterator[EvalSample]:
        for i in range(len(self)):
            yield self[i]


# --------------------------------------------------------------------------
# multiview train split
# --------------------------------------------------------------------------

def scan_multiview_pairs(root: str, mv_type: str,
                         cache: bool = True) -> List[Tuple[str, str]]:
    """Consecutive-frame pairs from the KITTI multiview extension, skipping
    the GT-annotated frames 9-12 (kitti_dataset.py:236), over both the
    'testing' and 'training' halves (:226)."""
    sub = {"2012": "data_stereo_flow_multiview",
           "2015": "data_scene_flow_multiview"}[mv_type]
    img_name = {"2012": "image_2", "2015": "image_2"}[mv_type]
    d_path = os.path.join(root, sub)
    cache_path = os.path.join(d_path, "upflow_tpu_mv_pairs_%s.pkl" % mv_type)
    if cache and os.path.isfile(cache_path):
        with open(cache_path, "rb") as f:
            return pickle.load(f)
    pairs: List[Tuple[str, str]] = []
    for split in ["testing", "training"]:
        img_dir = os.path.join(d_path, split, img_name)
        if not os.path.isdir(img_dir):
            # 2012 multiview uses colored_0 in some packagings
            alt = os.path.join(d_path, split, "colored_0")
            if os.path.isdir(alt):
                img_dir = alt
            else:
                continue
        files = sorted(os.listdir(img_dir))
        for ind in range(len(files) - 1):
            fid = int(files[ind][-6:-4])
            fid_next = int(files[ind + 1][-6:-4])
            if fid != fid_next - 1 or 9 <= fid <= 12 or 9 <= fid_next <= 12:
                continue
            pairs.append((os.path.join(img_dir, files[ind]),
                          os.path.join(img_dir, files[ind + 1])))
    if cache:
        try:
            with open(cache_path, "wb") as f:
                pickle.dump(pairs, f)
        except OSError:
            pass
    return pairs


class KittiMultiviewDataset:
    """Training items: full pair + random crop + crop offset.

    Returns dict(im1_raw, im2_raw, im1, im2, start) — NHWC float32 without
    the batch dim; ``start`` is (2,) float32 (x, y).
    """

    def __init__(self, root: str, mv_type: str = "2015",
                 crop_size: Tuple[int, int] = (256, 832), rho: int = 8,
                 swap_images: bool = True, normalize: bool = True,
                 horizontal_flip_aug: bool = True,
                 repeat: Optional[int] = None, seed: int = 0,
                 pairs: Optional[Sequence[Tuple[str, str]]] = None):
        self.pairs = list(pairs) if pairs is not None else \
            scan_multiview_pairs(root, mv_type)
        self.crop_size = crop_size
        self.rho = rho
        self.swap_images = swap_images
        self.normalize = normalize
        self.horizontal_flip_aug = horizontal_flip_aug
        self.repeat = repeat
        self.seed = seed
        self.N = len(self.pairs)

    def __len__(self):
        if self.repeat is None or self.repeat <= 0:
            return self.N
        return self.N * int(self.repeat)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return self.item(index, epoch=0)

    def item(self, index: int, epoch: int = 0) -> Dict[str, np.ndarray]:
        """Item with augmentation drawn statelessly from (seed, epoch,
        index) — thread-safe and mid-epoch-resumable (see data/rng.py)."""
        rng = item_rng(self.seed, epoch, index)
        p1, p2 = self.pairs[index % self.N]
        flip = self.horizontal_flip_aug and rng.random() < 0.5
        im1 = normalize_image(read_image(p1), self.normalize, flip)
        im2 = normalize_image(read_image(p2), self.normalize, flip)
        if self.swap_images and rng.random() < 0.5:
            im1, im2 = im2, im1
        h, w = im1.shape[:2]
        ph, pw = self.crop_size
        x = int(rng.integers(self.rho, w - self.rho - pw))
        y = int(rng.integers(self.rho, h - self.rho - ph))
        return {
            "im1_raw": im1,
            "im2_raw": im2,
            "im1": im1[y:y + ph, x:x + pw],
            "im2": im2[y:y + ph, x:x + pw],
            "start": np.array([x, y], np.float32),
        }
