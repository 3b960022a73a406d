"""Image reading and the UnFlow normalisation.

Port of ``upflow_pytorch_tpu/data/image_io.py``, the reference's
``img_func.get_process_img`` (``dataset/kitti_dataset.py:43-66``):
``(img - [104.92, 110.18, 114.79]) * 0.0039216`` on RGB uint8, HWC float32
out (the model takes NHWC arrays and moves them to the card itself).

Decoders, in the JAX package's order: the native C++ PNG decoder
(``data/native.py``), then cv2, then PIL, then the pure-numpy codec of
``flow_io``.  A PNG the native decoder rejects (an interlaced or 4-bit
file) goes on down the chain, as in the JAX package; whether the native
library is there at all is ``native.available()`` and, when it is not,
``native.build_error()``.
"""

from __future__ import annotations

import numpy as np

from upflow_pytorch_tpu_torch.data import native

UNFLOW_MEAN = np.array([104.920005, 110.1753, 114.785955], np.float32)
UNFLOW_SCALE = np.float32(0.0039216)  # 1/255, the reference's 1/stddev


def _to_rgb8(img: np.ndarray) -> np.ndarray:
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return img[:, :, :3]


def read_image(path: str) -> np.ndarray:
    """Read an image file -> (H, W, 3) uint8 RGB."""
    if path.lower().endswith(".png") and native.available():
        try:
            return _to_rgb8(native.decode_png(path))
        except IOError:
            pass
    try:
        import cv2
    except ImportError:
        pass
    else:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise IOError("cv2 failed to read %s" % path)
        return img[:, :, ::-1]  # BGR -> RGB
    try:
        from PIL import Image
    except ImportError:
        from upflow_pytorch_tpu_torch.data.flow_io import read_png
        return _to_rgb8(read_png(path))
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def normalize_image(img: np.ndarray, normalize: bool = True,
                    horizontal_flip: bool = False) -> np.ndarray:
    """uint8 RGB HWC -> normalized float32 HWC."""
    img = np.asarray(img)
    if horizontal_flip:
        img = img[:, ::-1]
    img = img.astype(np.float32)
    if normalize:
        img = (img - UNFLOW_MEAN) * UNFLOW_SCALE
    return np.ascontiguousarray(img)


def process_image(path: str, normalize: bool = True,
                  horizontal_flip: bool = False) -> np.ndarray:
    return normalize_image(read_image(path), normalize, horizontal_flip)
