#!/usr/bin/env python3
"""The KITTI fine-tune of the PyTorch port held against the JAX package's,
step by step, on the CPU.

    python3 scripts/torch_kitti_finetune_jax_reference.py [--steps 3]
        [--threshold 1.0] [--seed 0]

Writes a small multiview tree from ``--seed`` with
``scripts/torch_synthetic_trees.py`` (frames of ``MV_SIZE``) into a
temporary directory and a ``.pth`` of the snapshot
``assets/synthetic_trained.npz``, then runs the two training CLIs from
that ``.pth`` on that tree: ``scripts/train_kitti.py`` (the JAX package,
XLA on the CPU) and ``scripts/torch_train_kitti.py --device cpu`` (the
port's plain versions), each at ``--batch 2`` for ``--steps`` steps on
``CROP`` crops, with the warp-mask threshold ``--threshold`` on both
sides.  It prints each step's loss terms from both, the relative
difference of the total, and the cosine and largest relative difference
between the two runs' parameters after the last step (the JAX ones
carried to the port's names by ``checkpoint/convert.py``), as one JSON
line.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NPZ = ROOT / "assets" / "synthetic_trained.npz"
MV_SIZE, MV_FRAMES = (96, 224), 6
CROP, RHO = (64, 160), 8


def recorded(make_step, log):
    """``make_step`` whose steps append their metrics to ``log`` and keep
    the last state in ``log.state``."""

    def make(*args, **kwargs):
        step = make_step(*args, **kwargs)

        def run(state, batch):
            state, metrics = step(state, batch)
            log.append({k: float(v) for k, v in metrics.items()})
            recorded.state = state
            return state, metrics

        return run

    return make


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--threshold", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import flax
    import numpy as np
    import torch

    import torch_synthetic_trees as trees
    import torch_train_kitti
    import train_kitti
    import upflow_pytorch_tpu.ops.warp as jwarp
    from upflow_pytorch_tpu.data import kitti as jkitti
    from upflow_pytorch_tpu.train import trainer as jtrainer
    import upflow_pytorch_tpu_torch.ops.warp as pwarp
    from upflow_pytorch_tpu_torch.checkpoint.convert import params_from_jax
    from upflow_pytorch_tpu_torch.checkpoint.torch_import import (
        params_to_torch_state_dict)
    from upflow_pytorch_tpu_torch.data import kitti as pkitti
    from upflow_pytorch_tpu_torch.models.entry import build_model
    from upflow_pytorch_tpu_torch.train import trainer as ptrainer

    jwarp.MASK_THRESHOLD = pwarp.MASK_THRESHOLD = args.threshold
    trees.MV_SIZE, trees.MV_FRAMES = MV_SIZE, MV_FRAMES
    train_kitti.KittiMultiviewDataset = functools.partial(
        jkitti.KittiMultiviewDataset, crop_size=CROP, rho=RHO)
    torch_train_kitti.KittiMultiviewDataset = functools.partial(
        pkitti.KittiMultiviewDataset, crop_size=CROP, rho=RHO)
    logs = {"jax": [], "port": []}
    jtrainer.make_sharded_train_step = recorded(
        jtrainer.make_sharded_train_step, logs["jax"])
    ptrainer.make_train_step = recorded(ptrainer.make_train_step,
                                        logs["port"])
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "trees")
        trees.write_trees(root, args.seed, workers=4)
        model = build_model(torch_train_kitti.TRAIN_CONF, device="cpu",
                            weights=str(NPZ))
        pth = os.path.join(tmp, "snapshot.pth")
        torch.save(params_to_torch_state_dict(model), pth)
        common = ["--mv-root", root, "--batch", "2", "--steps",
                  str(args.steps), "--pretrained", pth]
        sys.argv = ["train_kitti.py", "--exp-dir",
                    os.path.join(tmp, "jax")] + common
        train_kitti.main()
        jax_params = jax.device_get(recorded.state.params)
        port = torch_train_kitti.main(
            ["--exp-dir", os.path.join(tmp, "port"), "--device", "cpu"]
            + common)
    flat = {"/".join(k): np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(jax_params).items()}
    want = params_from_jax(flat, port.model.state_dict().keys(), [])
    got = {n: p.detach() for n, p in port.model.named_parameters()}
    a = torch.cat([got[n].double().reshape(-1) for n in sorted(got)])
    b = torch.cat([want[n].double().reshape(-1) for n in sorted(got)])
    rel = {n: float((got[n].double() - want[n].double()).norm()
                    / want[n].double().norm()) for n in got}
    steps = [dict(jax=j, port=p, total_rel=abs(p["total_loss"]
                                               - j["total_loss"])
                  / abs(j["total_loss"]))
             for j, p in zip(logs["jax"], logs["port"])]
    for i, s in enumerate(steps):
        print("step %d: total JAX %.6f, port %.6f (%.2e relative)"
              % (i + 1, s["jax"]["total_loss"], s["port"]["total_loss"],
                 s["total_rel"]))
    print(json.dumps(dict(
        command="python3 scripts/torch_kitti_finetune_jax_reference.py "
                "--steps %d --threshold %r --seed %d"
                % (args.steps, args.threshold, args.seed),
        crop=CROP, mv_size=MV_SIZE, steps=steps,
        param_cosine=float(a @ b / (a.norm() * b.norm())),
        param_max_rel=max(rel.values()))))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
