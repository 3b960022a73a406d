#!/usr/bin/env python3
"""The JAX package's flow quality on the synthetic KITTI and Sintel trees
of ``scripts/torch_synthetic_trees.py``: the yardstick that the PyTorch
port's dataset path is held to (``chip_smoke.py`` phase 8).

    python3 scripts/torch_kitti_jax_reference.py [--out PATH] [--seed 0]

Writes the trees from ``--seed`` into a temporary directory, then runs
the JAX package on the CPU at fp32 (XLA, no Pallas) with the recipe of
``scripts/kitti_eval.py`` (``EVAL_CONF``), the snapshot
``assets/synthetic_trained.npz`` and the default mask threshold (1.0),
through the JAX package's own datasets (``KittiFlowEvalDataset``,
``SintelEvalDataset``), ``EvaluationBench`` and ``NetEvalModel``, one
pair a forward, on these lanes:

- ``kitti2015_native``: the KITTI 2015 training split at native size
  (375x1242, 376x1241, 370x1224, 374x1238);
- ``kitti2015_pad64``: the same pairs edge-padded to multiples of 64
  (384x1280) and the flow cropped back;
- ``kitti2012_native``: the KITTI 2012 training pair;
- ``sintel_final_native``: the Sintel final pass at 436x1024.

Per lane the file holds the bench's EPE-all, F1, EPE-noc and EPE-occ, the
frame sizes, and the command that made it.  The run is deterministic:
running it again gives the same values.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = (ROOT / "upflow_pytorch_tpu_torch" / "eval"
               / "jax_dataset_reference.json")
NPZ = ROOT / "assets" / "synthetic_trained.npz"
# scripts/kitti_eval.py's EVAL_CONF (the reference's test.py:22-30)
RECIPE = dict(if_norm_before_cost_volume=True,
              norm_moments_across_channels=False,
              norm_moments_across_images=False, if_froze_pwc=False,
              if_use_cor_pytorch=False, if_sgu_upsample=True)
# lane -> (dataset, split or render, pad_to_multiple)
LANES = {
    "kitti2015_native": ("kitti", "2015_train", None),
    "kitti2015_pad64": ("kitti", "2015_train", 64),
    "kitti2012_native": ("kitti", "2012_train", None),
    "sintel_final_native": ("sintel", "final", None),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "scripts"))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import flax
    import numpy as np

    import torch_synthetic_trees
    from upflow_pytorch_tpu.config import UPFlowConfig
    from upflow_pytorch_tpu.data.kitti import KittiFlowEvalDataset
    from upflow_pytorch_tpu.data.sintel import SintelEvalDataset
    from upflow_pytorch_tpu.eval.bench import EvaluationBench
    from upflow_pytorch_tpu.models.upflow import build_model
    from upflow_pytorch_tpu.train.trainer import NetEvalModel

    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    model = build_model(UPFlowConfig().updated(RECIPE))
    cache = {}
    lanes = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        torch_synthetic_trees.write_trees(root, args.seed)
        print("trees written in %.1f s" % (time.perf_counter() - t0))
        for name, (kind, split, pad) in LANES.items():
            dataset = (KittiFlowEvalDataset(root, split) if kind == "kitti"
                       else SintelEvalDataset(root, split))
            eval_model = NetEvalModel(model, params, jit_cache=cache,
                                      pad_to_multiple=pad)
            t0 = time.perf_counter()
            res = EvaluationBench(dataset)(eval_model)
            sizes = ["%dx%d" % s.im1.shape[1:3] for s in dataset]
            lanes[name] = dict(epe_all=res.epe_all, f1=res.f1,
                               epe_noc=res.epe_noc, epe_occ=res.epe_occ,
                               pairs=len(sizes), sizes=sizes,
                               pad_to_multiple=pad)
            print("%s: %s (%.1f s)" % (name, lanes[name],
                                       time.perf_counter() - t0), flush=True)
    doc = dict(
        source="JAX package on the CPU (XLA, no Pallas), fp32, "
               "scripts/kitti_eval.py's EVAL_CONF, mask threshold 1.0, "
               "assets/synthetic_trained.npz, the trees of "
               "scripts/torch_synthetic_trees.py; one pair a forward",
        command="python3 scripts/torch_kitti_jax_reference.py --seed %d"
                % args.seed,
        seed=args.seed, jax=jax.__version__, recipe=RECIPE, lanes=lanes)
    args.out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print("wrote %s" % args.out)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
