"""Unsupervised KITTI training entry point of the PyTorch port, the
``simple_train.py`` equivalent (``scripts/simple_train.py:82-208`` of the
reference).

The port's counterpart of ``scripts/train_kitti.py``, with its recipe
(``TRAIN_CONF``: photometric with boundary-dilated warping, edge-aware
smoothness, census, pyramid distillation, SGU upsampling, analytic
occlusion masks; Adam (AMSGrad) with weight decay 1e-4) and flags, plus
``--batch-per-epoch`` (steps between the evaluation and checkpoint at an
epoch's end) and ``--device``.  Runs on the GPU unless ``--device cpu`` is
given.  ``--data-axis N`` trains on N cards, one process each, started by
``torchrun``; ``--batch`` is the global batch.  With ``--device cpu`` the
N processes reduce over gloo.

Usage:
    python scripts/torch_train_kitti.py --mv-root /path/to/KITTI_mv \\
        --eval-root /path/to/KITTI_data --exp-dir ./exp1
    torchrun --nproc_per_node 8 scripts/torch_train_kitti.py \\
        --mv-root /path/to/KITTI_mv --data-axis 8 --batch 16
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
from typing import Optional, Sequence

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.kitti import (
    KittiFlowEvalDataset, KittiMultiviewDataset)
from upflow_pytorch_tpu_torch.eval.bench import EvaluationBench
from upflow_pytorch_tpu_torch.parallel.mesh import (
    close_distributed, init_distributed)
from upflow_pytorch_tpu_torch.train.trainer import Trainer

TRAIN_CONF = UPFlowConfig().updated(dict(
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    photo_loss_census_weight=1.0,
    multi_scale_distillation_weight=0.01,
    multi_scale_distillation_style="upup",
    multi_scale_distillation_occ=True,
    if_use_boundary_warp=True,
    if_sgu_upsample=True,
))


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mv-root", required=True,
                    help="dir containing data_scene_flow_multiview/")
    ap.add_argument("--eval-root", default=None,
                    help="dir containing data_scene_flow/ (KITTI 2015 GT)")
    ap.add_argument("--mv-type", default="2015", choices=["2012", "2015"])
    ap.add_argument("--exp-dir", default="./demo_exp")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch-per-epoch", type=int,
                    default=TrainerConfig.batch_per_epoch,
                    help="steps an epoch; each epoch ends with an "
                         "evaluation and a checkpoint")
    ap.add_argument("--data-axis", type=int, default=1,
                    help="data-parallel ranks, one card each; start the "
                         "script with torchrun --nproc_per_node N")
    ap.add_argument("--pretrained", default=None, help=".pth to warm-start")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-sgu", action="store_true",
                    help="phase-1 recipe without SGU (simple_train.py:177)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without it)")
    args = ap.parse_args(argv)

    model_conf = TRAIN_CONF
    if args.no_sgu:
        model_conf = model_conf.updated(dict(if_sgu_upsample=False))
    trainer_conf = TrainerConfig(exp_dir=args.exp_dir, batchsize=args.batch,
                                 lr=args.lr, data_axis=args.data_axis,
                                 batch_per_epoch=args.batch_per_epoch)

    train_set = KittiMultiviewDataset(args.mv_root, args.mv_type)
    bench = None
    if args.eval_root:
        bench = EvaluationBench(KittiFlowEvalDataset(args.eval_root,
                                                     "2015_train"))
    # under torchrun (WORLD_SIZE set) every run joins the group, even of 1
    joined = args.data_axis > 1 or "WORLD_SIZE" in os.environ
    device = init_distributed(device=args.device) if joined else args.device
    try:
        trainer = Trainer(model_conf, trainer_conf, train_set, bench,
                          device=device)
        try:
            if args.pretrained:
                trainer.load_pretrained(args.pretrained)
            if args.resume:
                trainer.try_resume()
            trainer.train(total_steps=args.steps)
        finally:
            trainer.loader.close()
    finally:
        if joined:
            close_distributed()
    return trainer


if __name__ == "__main__":
    main()
