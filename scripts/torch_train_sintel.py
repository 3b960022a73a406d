"""MPI-Sintel fine-tuning entry point of the PyTorch port (full-resolution
Sintel fine-tune of the UPFlow paper).

The port's counterpart of ``scripts/train_sintel.py``, with its recipe
(``FT_CONF``) and flags, plus ``--device``.  Runs on the GPU unless
``--device cpu`` is given.  ``--data-axis N`` trains on N cards, one
process each, started by ``torchrun``; ``--batch`` is the global batch.
With ``--device cpu`` the N processes reduce over gloo.

Usage:
    python scripts/torch_train_sintel.py --root /data/Sintel --render final \\
        --pretrained upflow_kitti2015.pth --exp-dir ./sintel_ft
    torchrun --nproc_per_node 8 scripts/torch_train_sintel.py \\
        --root /data/Sintel --data-axis 8 --batch 8
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
from upflow_pytorch_tpu_torch.parallel.mesh import (
    close_distributed, init_distributed)
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
                    help="data-parallel ranks, one card each; start the "
                         "script with torchrun --nproc_per_node N")
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
    # under torchrun (WORLD_SIZE set) every run joins the group, even of 1
    joined = args.data_axis > 1 or "WORLD_SIZE" in os.environ
    device = init_distributed(device=args.device) if joined else args.device
    try:
        trainer = Trainer(FT_CONF, trainer_conf, train_set, bench,
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
