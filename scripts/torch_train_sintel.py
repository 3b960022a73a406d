"""MPI-Sintel fine-tuning entry point of the PyTorch port (full-resolution
Sintel fine-tune of the UPFlow paper).

The port's counterpart of ``scripts/train_sintel.py``, with its recipe
(``FT_CONF``) and flags, plus ``--device``.  ``--data-axis`` other than 1
raises until multi-GPU training is ported.  Runs on the GPU unless
``--device cpu`` is given.

Usage:
    python scripts/torch_train_sintel.py --root /data/Sintel --render final \\
        --pretrained upflow_kitti2015.pth --exp-dir ./sintel_ft
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
from typing import Optional, Sequence

from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
from upflow_pytorch_tpu_torch.data.sintel import (
    SintelEvalDataset, SintelTrainDataset)
from upflow_pytorch_tpu_torch.eval.bench import EvaluationBench
from upflow_pytorch_tpu_torch.train.trainer import Trainer

FT_CONF = UPFlowConfig().updated(dict(
    if_norm_before_cost_volume=True,
    norm_moments_across_channels=False,
    norm_moments_across_images=False,
    photo_loss_census_weight=1.0,
    multi_scale_distillation_weight=0.01,
    if_use_boundary_warp=True,
    if_sgu_upsample=True,
))


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True, help="Sintel root dir")
    ap.add_argument("--render", default="final", choices=["clean", "final"])
    ap.add_argument("--exp-dir", default="./sintel_ft")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-5)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--data-axis", type=int, default=1,
                    help="data-parallel devices (only 1 until multi-GPU "
                         "training is ported)")
    ap.add_argument("--crop", type=int, nargs=2, default=(384, 768))
    ap.add_argument("--pretrained", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without it)")
    args = ap.parse_args(argv)

    trainer_conf = TrainerConfig(exp_dir=args.exp_dir, batchsize=args.batch,
                                 lr=args.lr, data_axis=args.data_axis)
    train_set = SintelTrainDataset(args.root, args.render,
                                   crop_size=tuple(args.crop))
    bench = EvaluationBench(SintelEvalDataset(args.root, args.render))
    trainer = Trainer(FT_CONF, trainer_conf, train_set, bench,
                      device=args.device)
    try:
        if args.pretrained:
            trainer.load_pretrained(args.pretrained)
        if args.resume:
            trainer.try_resume()
        trainer.train(total_steps=args.steps)
    finally:
        trainer.loader.close()
    return trainer


if __name__ == "__main__":
    main()
