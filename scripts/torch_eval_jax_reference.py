#!/usr/bin/env python3
"""The JAX package's flow quality on the evaluation pairs of the PyTorch
port's ``chip_smoke.py`` phase 5: the yardstick its EPE is held to.

    python3 scripts/torch_eval_jax_reference.py [--out PATH]

Runs the JAX package on the CPU at fp32 (XLA everywhere, no Pallas), with
the recipe of ``bench.py``'s fp32 oracle (normalised cost volume, moments
off, SGU, ``if_use_cor_pytorch=True``), the snapshot
``assets/synthetic_trained.npz`` and the default mask threshold (1.0),
through the JAX package's own ``NetEvalModel`` and ``EvaluationBench``,
over the pairs that phase 5 evaluates:

- ``b4_384x1280``: ``make_dataset(4, seed=7, raw_hw=(384, 1280),
  crop_hw=(384, 1280))``, the pairs of ``bench.py``;
- ``b1_375x1242_native``: ``make_dataset(2, seed=11, raw_hw=(375, 1242),
  crop_hw=(375, 1242))`` at KITTI's native size;
- ``b1_375x1242_pad64``: the same pairs edge-padded to multiples of 64
  (384x1280) and the flow cropped back.

Every pair runs as its own batch of one: the recipe takes its moments per
image, so a pair's flow does not depend on the rest of its batch, and one
pair at a time keeps the CPU's memory small.  With all-ones masks the
bench's EPE-all and F1 of four batches of one equal those of one batch of
four.  Per request the file holds EPE-all and F1 (``EvaluationBench``) and
the interior EPE, 8 px cropped (``data/synthetic.epe``, as ``bench.py``
computes it), with the command that made it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = (ROOT / "upflow_pytorch_tpu_torch" / "eval"
               / "jax_reference_epe.json")
NPZ = ROOT / "assets" / "synthetic_trained.npz"
RECIPE = dict(if_norm_before_cost_volume=True,
              norm_moments_across_channels=False,
              norm_moments_across_images=False,
              if_sgu_upsample=True, if_use_cor_pytorch=True)
# request -> (make_dataset arguments, pad_to_multiple)
REQUESTS = {
    "b4_384x1280": (dict(n_pairs=4, seed=7, raw_hw=(384, 1280),
                         crop_hw=(384, 1280)), None),
    "b1_375x1242_native": (dict(n_pairs=2, seed=11, raw_hw=(375, 1242),
                                crop_hw=(375, 1242)), None),
    "b1_375x1242_pad64": (dict(n_pairs=2, seed=11, raw_hw=(375, 1242),
                               crop_hw=(375, 1242)), 64),
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import flax
    import numpy as np

    from upflow_pytorch_tpu.config import UPFlowConfig
    from upflow_pytorch_tpu.data.synthetic import epe, make_dataset
    from upflow_pytorch_tpu.eval.bench import EvalSample, EvaluationBench
    from upflow_pytorch_tpu.models.upflow import build_model
    from upflow_pytorch_tpu.train.trainer import NetEvalModel

    class Keeping(NetEvalModel):
        """The JAX package's eval model, keeping each prediction."""

        def eval_save_result(self, save_name, predflow, *a, **kw):
            self.preds.append(np.asarray(predflow))

    with np.load(NPZ) as z:
        params = flax.traverse_util.unflatten_dict(
            {tuple(k.split("/")): z[k] for k in z.files})
    model = build_model(UPFlowConfig().updated(RECIPE))
    cache = {}
    result = {}
    for name, (kw, pad) in REQUESTS.items():
        kw = dict(kw)
        data = make_dataset(kw.pop("n_pairs"), **kw)
        eval_model = Keeping(model, params, jit_cache=cache,
                             pad_to_multiple=pad)
        eval_model.preds = []
        samples = [EvalSample(im1=data["im1"][i:i + 1],
                              im2=data["im2"][i:i + 1],
                              flow_occ=data["gt_flow"][i:i + 1],
                              mask_occ=np.ones_like(data["gt_flow"][i:i + 1,
                                                                    ..., :1]),
                              flow_noc=data["gt_flow"][i:i + 1],
                              mask_noc=np.ones_like(data["gt_flow"][i:i + 1,
                                                                    ..., :1]))
                   for i in range(len(data["im1"]))]
        t0 = time.perf_counter()
        res = EvaluationBench(samples)(eval_model)
        pred = np.concatenate(eval_model.preds)
        result[name] = dict(
            pairs=len(samples), hw=list(data["im1"].shape[1:3]),
            pad_to_multiple=pad, epe_all=res.epe_all, f1=res.f1,
            epe_interior=epe(pred, data["gt_flow"]))
        print("%s: %s (%.1f s)" % (name, result[name],
                                   time.perf_counter() - t0), flush=True)
    doc = dict(
        source="JAX package on the CPU (XLA, no Pallas), fp32, recipe of "
               "bench.py's fp32 oracle with if_use_cor_pytorch=True, "
               "mask threshold 1.0, assets/synthetic_trained.npz; one pair "
               "a forward",
        command="python3 scripts/torch_eval_jax_reference.py",
        jax=jax.__version__, recipe=RECIPE, requests=result)
    args.out.write_text(json.dumps(doc, indent=1, sort_keys=True) + "\n")
    print("wrote %s" % args.out)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.exit(main())
