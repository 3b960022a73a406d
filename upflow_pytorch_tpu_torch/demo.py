"""Smoke demo, the ``UPFlow_net.demo()`` analog
(``model/upflow.py:589-641`` of the reference).

Port of ``upflow_pytorch_tpu/demo.py``: random input through the full
training-config forward and losses (``forward_with_loss``), printing the
same keys and tensor statistics.  The weights are Kaiming-normal from a
``torch.Generator`` seeded with 0 (``build_model``), the input from
``np.random.RandomState(0)``.

Run: ``python -m upflow_pytorch_tpu_torch.demo [--size N] [--device cpu]``
(the card unless ``--device cpu`` is asked for).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.models.entry import build_model
from upflow_pytorch_tpu_torch.models.upflow import forward_with_loss
from upflow_pytorch_tpu_torch.utils.debug import check_tensor, count_params

DEMO_CONF = UPFlowConfig().updated(dict(
    photo_loss_census_weight=1,
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    multi_scale_distillation_weight=1,
    multi_scale_distillation_style="upup",
    multi_scale_distillation_occ=True,
    if_use_boundary_warp=True,
    if_use_cor_pytorch=True,
    if_sgu_upsample=True,
))


def _item(val) -> Optional[float]:
    return None if val is None else float(val)


def demo(size: int = 320, device=None) -> Dict[str, Any]:
    """One forward with losses at (1, size, size) on ``device`` (the card
    unless ``"cpu"`` is asked for); prints and returns its outputs."""
    print(DEMO_CONF.get_name())
    model = build_model(DEMO_CONF, device, seed=0)
    print("params:", count_params(model))
    rng = np.random.RandomState(0)
    im = rng.random((1, size, size, 3)).astype(np.float32)
    start = np.zeros((1, 2), np.float32)
    batch = {"im1": im, "im2": im, "im1_raw": im, "im2_raw": im,
             "start": start}
    with torch.no_grad():
        out = forward_with_loss(model, batch)
    print("smooth_loss", _item(out["smooth_loss"]),
          "photo_loss", _item(out["photo_loss"]),
          "census_loss", _item(out["census_loss"]))
    for key in ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw",
                "im1_warp", "im2_warp"):
        check_tensor(out[key], key)
    for key in ("msd_loss", "total_loss"):
        print(key, _item(out[key]))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=320)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    return demo(args.size, args.device)


if __name__ == "__main__":
    main()
