"""Training steps back to back: the port's ``train/step.py::
make_train_step`` (the model, the loss, its backward and Adam with AMSGrad
under the step's deterministic numerics) on batches drawn in turn from a
pool on the device, every step's metrics read to the host as the
``Trainer`` reads them.

Traffic parameters (``benchmark/traffic/<mix>.json``): ``batch``,
``raw_height_width`` and ``crop_height_width`` (each item's uncropped
frames and its crop, at a start drawn from the seed), ``pool_batches``
distinct batches (``batch`` x ``pool_batches`` pairs), ``motion``,
``checked_steps`` (the first steps, made in set-up),
``window_checked_steps`` (the most of the window's first steps that are
checked too; the number, from 1 up, is drawn from the seed) and
``profile_steps`` (the traced slice).

The step object that set-up builds and drives through the checked steps
is the one the window runs on.  The window keeps the loss of each of its
first k steps (read to the host in any case) and a copy of the parameters
after its step k.  ``correct``: the reference follows all those steps
from the same weights and batches, and the numbers are the worst step's
relative gap of the total loss, and by the worst leaf the gap between the
program's and the reference's norms of the first gradient as the
optimizer took it (read from Adam's first moment after step 1) and of
each parameter's change from the weights to window step k, against the
larger of the reference's norm of that leaf and of the median leaf.
Leaves whose reference gradient is under a thousandth of the median
leaf's move by round-off alone and are left out of the change.
"""

from __future__ import annotations

import math
import re
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.core import trace
from benchmark.core.runner import Check, Window
from benchmark.drivers import common
from benchmark.reference import amsgrad, losses, lowp, npz, synthetic
from benchmark.reference import upflow as reference

# the port's parameter names -> the reference's leaves
_NAMES = (
    (r"feature_pyramid_extractor\.convs\.(\d)\.(\d)\.0\.",
     r"feature_pyramid_extractor/level\1_conv\2."),
    (r"flow_estimators\.(conv\w+)\.0\.", r"flow_estimators/\1."),
    (r"context_networks\.convs\.(\d)\.0\.", r"context_networks/conv\1."),
    (r"conv_1x1\.(\d)\.0\.", r"conv_1x1_\1."),
    (r"sgi_model\.dense_estimator_mask\.(conv\w+)\.0\.",
     r"sgu_dense_estimator/dense/\1."),
    (r"sgi_model\.upsample_output_conv\.(\d)\.0\.",
     r"sgu_output_conv/conv\1."),
)
ROUND_OFF_LEAF = 1e-3  # of the median leaf's gradient norm


def leaf_of(name: str) -> str:
    for pattern, repl in _NAMES:
        if re.match(pattern, name):
            return re.sub(pattern, repl, name)
    raise KeyError(name)


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             leaves) -> float:
    """The worst leaf's |got - ref| against the larger of the reference's
    norm of that leaf and of the median leaf."""
    median = statistics.median(ref[k] for k in leaves)
    return max(abs(got[k] - ref[k]) / max(ref[k], median, 1e-30)
               for k in leaves)


class Driver:
    def __init__(self, run, root):
        self.run, self.root = run, root
        t = run.traffic
        self.batch = int(t["batch"])
        self.device = run.device
        self.weights = str(root / run.config["weights"])
        self.checked = int(t["checked_steps"])
        rng = np.random.default_rng([run.seed, 3])
        self.window_checked = int(rng.integers(
            1, int(t["window_checked_steps"]) + 1))

    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        clock = common.Stopwatch(run.setup_parts)
        conf = common.program_config(run.config)
        from upflow_pytorch_tpu_torch.config import TrainerConfig
        from upflow_pytorch_tpu_torch.train import step

        clock.lap("program import")
        tconf = TrainerConfig().updated(run.config["trainer"])
        self.model, self.state, self.optimizer = step.create_train_state(
            conf, tconf, self.device, self.weights)
        self.step = step.make_train_step(self.model, self.optimizer)
        self.beta1 = self.optimizer.param_groups[0]["betas"][0]
        clock.lap("model and weights")
        n = int(t["pool_batches"])
        pool = synthetic.render(
            run.seed, range(n * self.batch), tuple(t["raw_height_width"]),
            tuple(t["crop_height_width"]), t["motion"], self.device)
        self.batches = [{k: v[i * self.batch:(i + 1) * self.batch]
                         for k, v in pool.items()} for i in range(n)]
        clock.lap("inputs")
        named = dict(self.model.named_parameters())
        self.start = {k: p.detach().clone() for k, p in named.items()}
        self.losses: List[float] = []
        for i in range(self.checked):
            self.losses.append(self._call(i)[1]["total_loss"])
            if i == 0:
                self.grad_norms = {leaf_of(k): self._first_gradient(p)
                                   for k, p in named.items()}
        self.window_losses: List[float] = []
        self.kept: Optional[Dict[str, torch.Tensor]] = None
        clock.lap("warm-up (the checked steps)")
        self.next = self.checked
        common.reset_peak(self.device)

    def _first_gradient(self, p) -> float:
        """The norm of the gradient that the optimizer's first step took,
        from its first moment (none: it took none)."""
        m = self.optimizer.state.get(p, {}).get("exp_avg")
        return 0.0 if m is None else float(m.norm()) / (1 - self.beta1)

    def _call(self, i: int):
        """Step ``i`` on its batch; returns (enqueue seconds, metrics)."""
        t0 = time.perf_counter()
        self.state, metrics = self.step(self.state,
                                        self.batches[i % len(self.batches)])
        t1 = time.perf_counter()
        return t1 - t0, {k: float(v) for k, v in metrics.items()}

    def window(self, seconds: float) -> Window:
        latency, enqueue, ends, failed = [], [], [], 0
        start = time.perf_counter()
        end = start
        while True:
            t0 = time.perf_counter()
            if t0 - start >= seconds:
                break
            enq, metrics = self._call(self.next)
            if len(self.window_losses) < self.window_checked:
                self.window_losses.append(metrics["total_loss"])
                self.kept = {k: p.detach().clone()
                             for k, p in self.model.named_parameters()}
            end = time.perf_counter()
            failed += not math.isfinite(metrics["total_loss"])
            latency.append(end - t0)
            enqueue.append(enq)
            ends.append(end - start)
            self.next += 1
        n = len(latency)
        return Window(end - start, n, n * self.batch, latency, enqueue,
                      ends, failed)

    def peak_bytes(self) -> int:
        return common.peak_bytes(self.device)

    def profile(self, ops) -> trace.Trace:
        n = int(self.run.traffic["profile_steps"])

        def steps() -> int:
            for _ in range(n):
                self._call(self.next)
                self.next += 1
            return n

        return trace.capture(steps, self.device, ops,
                             self.run.config["program"], 1)

    def flops_per_unit(self) -> float:
        """The reference step's forward and backward FLOPs, per pair."""
        t = self.run.traffic
        p = {k: v.requires_grad_(True)
             for k, v in common.meta_params(self.weights).items()}
        b, (h, w), (rh, rw) = (self.batch, t["crop_height_width"],
                               t["raw_height_width"])
        batch = {"im1": torch.empty((b, h, w, 3), device="meta"),
                 "im2": torch.empty((b, h, w, 3), device="meta"),
                 "im1_raw": torch.empty((b, rh, rw, 3), device="meta"),
                 "im2_raw": torch.empty((b, rh, rw, 3), device="meta"),
                 "start": torch.empty((b, 2), device="meta")}

        def step():
            total = self._loss(p, batch, common.numerics(self.run.config))
            torch.autograd.grad(total["total_loss"], list(p.values()))

        return common.count_flops(step) / b

    def release(self) -> None:
        self.model = self.state = self.optimizer = self.step = None
        common.free(self.device)

    # --- the check ----------------------------------------------------------

    def _loss(self, p, batch, num):
        u = self.run.config["upflow"]
        return losses.loss_terms(p, batch, u["photo_loss_census_weight"],
                                 u["multi_scale_distillation_weight"], num)

    def reference_steps(self, control=None, frozen_after=None):
        """The reference's checked steps, set-up's and the window's, from
        the snapshot: (total losses, first gradients' norms, changes'
        norms), fp32 with TF32 off or in a control's precision.  From step
        ``frozen_after`` on, the optimizer leaves the state unchanged (a
        fault)."""
        tr = self.run.config["trainer"]
        p = npz.load_params(self.weights, self.device)
        start = {k: v.clone() for k, v in p.items()}
        for v in p.values():
            v.requires_grad_(True)
        opt = amsgrad.AMSGrad(p, tr["lr"], tr["weight_decay"])
        quant, tf32 = lowp.CONTROLS[control]
        num = common.numerics(self.run.config, quant)
        totals, grad_norms = [], {}
        steps = self.checked + len(self.window_losses)
        with reference.fp32(tf32):
            for i in range(steps):
                batch = self.batches[i % len(self.batches)]
                loss = self._loss(p, batch, num)["total_loss"]
                totals.append(float(loss.detach()))
                if frozen_after is not None and i >= frozen_after:
                    continue
                grads = torch.autograd.grad(loss, list(p.values()))
                used = opt.step(dict(zip(p.keys(), grads)))
                if i == 0:
                    grad_norms = {k: float(g.norm()) for k, g in used.items()}
                del loss, grads, used
        changes = {k: float((v.detach() - start[k]).norm())
                   for k, v in p.items()}
        return totals, grad_norms, changes

    def compare(self, got, ref) -> Dict[str, float]:
        (loss, grad, change), (r_loss, r_grad, r_change) = got, ref
        median = statistics.median(r_grad.values())
        moved = [k for k in r_grad if r_grad[k] >= ROUND_OFF_LEAF * median]
        print("change compared on %d of %d leaves; left out: %s" % (
            len(moved), len(r_grad), sorted(set(r_grad) - set(moved))),
            file=sys.stderr)
        return {
            "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(loss, r_loss)),
            "grad_norm_gap": leaf_gap(grad, r_grad, list(r_grad)),
            "change_norm_gap": leaf_gap(change, r_change, moved)}

    def judge(self, limits: Dict[str, float]) -> List[Check]:
        if self.kept is None:
            return [Check("window_steps_checked", 0.0, -1.0)]
        changes = {leaf_of(k): float((v - self.start[k]).norm())
                   for k, v in self.kept.items()}
        print("steps checked: %d of set-up, %d of the window"
              % (self.checked, len(self.window_losses)), file=sys.stderr)
        numbers = self.compare(
            (self.losses + self.window_losses, self.grad_norms, changes),
            self.reference_steps())
        return [Check(k, v, float(limits[k])) for k, v in numbers.items()]

    def control(self) -> Dict[str, float]:
        return self.compare(self.reference_steps(self.run.config["control"]),
                            self.reference_steps())
