"""Train the port on the synthetic exact-ground-truth dataset, reporting
the EPE against the true flow as training proceeds.

The port's counterpart of ``scripts/train_synthetic.py``, with the same
arguments and report: the full unsupervised recipe (photometric, census,
smoothness, distillation, SGU, boundary-dilated warp) at fp32 on pairs of
``upflow_pytorch_tpu_torch/data/synthetic.py``, whose flow is known in
closed form.  ``--out`` writes an ``.npz`` snapshot that the JAX
package's ``load_params_npz`` reads.  Runs on the GPU unless
``--device cpu`` is given.

Usage:
    python scripts/torch_train_synthetic.py --steps 600 \
        --out /tmp/synthetic_trained_torch.npz
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--raw-margin", type=int, default=16)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--out", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--init", default="",
                    help="warm-start from an .npz snapshot (fresh optimizer)")
    ap.add_argument("--max-shift", type=float, default=4.0)
    ap.add_argument("--max-rot", type=float, default=0.008)
    ap.add_argument("--max-zoom", type=float, default=0.01)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run without the GPU")
    args = ap.parse_args()
    if args.raw_margin < int(args.max_shift) + 2:
        ap.error("raw margin must cover the shift range for the boundary "
                 "warp")

    from upflow_pytorch_tpu_torch.config import TrainerConfig, UPFlowConfig
    from upflow_pytorch_tpu_torch.data.synthetic import epe, make_dataset
    from upflow_pytorch_tpu_torch.models.entry import forward
    from upflow_pytorch_tpu_torch.train.step import (
        create_train_state, make_train_step)

    conf = UPFlowConfig().updated(dict(
        if_norm_before_cost_volume=True,
        norm_moments_across_channels=False,
        norm_moments_across_images=False,
        if_sgu_upsample=True,
        if_use_cor_pytorch=True,
        photo_loss_census_weight=1.0,
        multi_scale_distillation_weight=0.01,
        multi_scale_distillation_style="upup",
        multi_scale_distillation_occ=True,
        if_use_boundary_warp=True,
    ))
    trainer_conf = TrainerConfig().updated(dict(lr=args.lr))

    data = make_dataset(
        args.pairs, seed=args.seed,
        raw_hw=(args.height + 2 * args.raw_margin,
                args.width + 2 * args.raw_margin),
        crop_hw=(args.height, args.width),
        max_shift=args.max_shift, max_rot=args.max_rot,
        max_zoom=args.max_zoom)
    gt = data.pop("gt_flow")

    model, state, optimizer = create_train_state(
        conf, trainer_conf, device=args.device,
        weights=args.init or None, seed=args.seed)
    if args.init:
        print("warm-started from", args.init)
    device = next(model.parameters()).device
    data = {k: torch.from_numpy(v).to(device) for k, v in data.items()}
    train_step = make_train_step(model, optimizer)

    def eval_epe():
        es = []
        for i in range(0, args.pairs, args.batch):
            pred = forward(model, data["im1"][i:i + args.batch],
                           data["im2"][i:i + args.batch])["flow_f_out"]
            es.append(epe(pred.cpu().numpy(), gt[i:i + args.batch]))
        return float(np.mean(es))

    rng = np.random.RandomState(args.seed + 1)
    history = []
    t0 = time.time()
    e0 = eval_epe()
    gt_mag = float(np.linalg.norm(gt, axis=-1).mean())
    print(f"step 0: epe={e0:.3f} (gt mean magnitude {gt_mag:.2f}px)")
    history.append((0, e0))
    for step in range(1, args.steps + 1):
        idx = torch.from_numpy(rng.choice(args.pairs, args.batch,
                                          replace=False)).to(device)
        batch = {k: v[idx] for k, v in data.items()}
        state, metrics = train_step(state, batch)
        if step % args.eval_every == 0 or step == args.steps:
            e = eval_epe()
            history.append((step, e))
            print(f"step {step}: epe={e:.3f} "
                  f"total_loss={float(metrics['total_loss']):.4f} "
                  f"({time.time() - t0:.0f}s)")

    if args.out:
        from upflow_pytorch_tpu_torch.checkpoint.npz_io import save_params_npz
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        save_params_npz(args.out, model)
        print("saved", args.out)
    print(json.dumps({"epe_history": history, "gt_mean_mag_px": gt_mag}))


if __name__ == "__main__":
    main()
