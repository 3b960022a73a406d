"""KITTI evaluation entry point of the PyTorch port, the ``test.py``
equivalent (``test.py:19-64`` of the reference).

The port's counterpart of ``scripts/kitti_eval.py``, with its recipe
(``EVAL_CONF``) and flags: ``--ckpt`` merges a reference ``.pth`` through
``checkpoint/torch_import.py``, ``--state-ckpt`` restores the model of a
``checkpoint/state_io.py`` directory (the JAX script's ``--orbax-ckpt``);
then the KITTI eval bench prints EPE All / F1 / EPE Noc / EPE Occ with the
reference's metric math.  Runs on the GPU unless ``--device cpu`` is
given.

Usage:
    python scripts/torch_kitti_eval.py --data-root /path/to/KITTI_data \\
        --split 2015_train --ckpt upflow_kitti2015.pth
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
from typing import Optional, Sequence

import numpy as np

from upflow_pytorch_tpu_torch.checkpoint.state_io import restore_checkpoint
from upflow_pytorch_tpu_torch.checkpoint.torch_import import (
    load_pretrained_params)
from upflow_pytorch_tpu_torch.config import UPFlowConfig
from upflow_pytorch_tpu_torch.data.flow_io import write_flow_png
from upflow_pytorch_tpu_torch.data.kitti import KittiFlowEvalDataset
from upflow_pytorch_tpu_torch.eval.bench import BenchResult, EvaluationBench
from upflow_pytorch_tpu_torch.models.entry import build_model
from upflow_pytorch_tpu_torch.train.trainer import NetEvalModel

# the reference eval config (test.py:22-30)
EVAL_CONF = UPFlowConfig().updated(dict(
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    if_froze_pwc=False,
    if_use_cor_pytorch=False,
    if_sgu_upsample=True,
))


class SavingModel(NetEvalModel):
    """Writes each predicted flow as a KITTI 16-bit PNG (the submission
    format), ``<save_dir>/<save_name>.png``."""

    def __init__(self, model, save_dir: str,
                 pad_to_multiple: Optional[int] = None):
        super().__init__(model, pad_to_multiple=pad_to_multiple)
        self.save_dir = save_dir

    def eval_save_result(self, save_name, predflow, *args, **kwargs):
        flow = np.asarray(predflow)[0]
        write_flow_png(os.path.join(self.save_dir, "%s.png" % save_name),
                       flow)


def main(argv: Optional[Sequence[str]] = None) -> Optional[BenchResult]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-root", required=True,
                    help="dir containing data_scene_flow/ and "
                         "data_stereo_flow/")
    ap.add_argument("--split", default="2015_train",
                    choices=["2012_train", "2015_train", "2012_test",
                             "2015_test"])
    ap.add_argument("--ckpt", default=None, help="reference .pth checkpoint")
    ap.add_argument("--state-ckpt", default=None,
                    help="checkpoint directory of the port's trainer "
                         "(the newest step's model)")
    ap.add_argument("--save-dir", default=None,
                    help="write predicted flows as KITTI 16-bit PNGs "
                         "(submission format) to this directory")
    ap.add_argument("--pad-multiple", type=int, default=None,
                    help="edge-pad frames to multiples of N (a few shapes "
                         "for all sizes; slightly off native-size parity)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without it)")
    args = ap.parse_args(argv)

    model = build_model(EVAL_CONF, args.device)
    if args.ckpt:
        load_pretrained_params(args.ckpt, model, verbose=True)
    elif args.state_ckpt:
        payload = restore_checkpoint(args.state_ckpt,
                                     map_location=next(model.parameters()
                                                       ).device)
        model.load_state_dict(payload["model"])

    dataset = KittiFlowEvalDataset(args.data_root, args.split)
    bench = EvaluationBench(dataset,
                            is_test_split=args.split.endswith("_test"),
                            verbose=True)
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        eval_model = SavingModel(model, args.save_dir,
                                 pad_to_multiple=args.pad_multiple)
    else:
        eval_model = NetEvalModel(model, pad_to_multiple=args.pad_multiple)
    res = bench(eval_model)
    if res is not None:
        print("EPE All = %.2f, F1 = %.2f, EPE Noc = %.2f, EPE Occ = %.2f"
              % (res.epe_all, res.f1, res.epe_noc, res.epe_occ))
    return res


if __name__ == "__main__":
    main()
