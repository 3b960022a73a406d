"""Data of the port: the KITTI and Sintel datasets and their codecs (PNG,
KITTI flow PNG, ``.flo``; the native C++ decoder), synthetic pairs with
exact ground-truth flow, the per-item random draws and the resumable
batch loader."""

from upflow_pytorch_tpu_torch.data.flow_io import (
    read_flow_png,
    write_flow_png,
    read_flo,
    write_flo,
)
from upflow_pytorch_tpu_torch.data.image_io import read_image, normalize_image

__all__ = [
    "read_flow_png",
    "write_flow_png",
    "read_flo",
    "write_flo",
    "read_image",
    "normalize_image",
]
