"""RAFT served in a closed loop: ``serve_closed_loop``'s client, window,
profiled slices and check, with RAFT's set-up, FLOP count and reference.

The configuration file's ``raft`` holds the ``RAFTConfig`` fields it
sets (``iters``, ``compute_dtype``) and its top-level widths are RAFT's
published ones, which the set-up holds the program's to.  The weights are
drawn here from the run's seed and the widths (RAFT's initialisation,
``reference/raft.py::init_params``), saved as a state dict under the
run's temporary directory and loaded by the program's
``build_model(conf, weights=...)``: the reference never takes the
program's initialisation.  The pairs are ``serve_closed_loop``'s
synthetic KITTI pairs mapped from their +-0.45 to RAFT's [0, 255].

``correct``: as ``serve_closed_loop``, against ``reference/raft.py`` run
in blocks of ``reference_pairs``, both directions of each pair.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, Sequence

import torch

from benchmark.drivers import common
from benchmark.drivers import serve_closed_loop as base
from benchmark.reference import lowp, synthetic
from benchmark.reference import raft as reference
from benchmark.reference.upflow import fp32

KEYS = base.KEYS
WIDTHS = ("feature_dim", "hidden_dim", "context_dim", "corr_levels",
          "corr_radius")


def to_pixels(im: torch.Tensor) -> torch.Tensor:
    """A synthetic image's +-AMPLITUDE mapped onto [0, 255]."""
    return (im / (2 * synthetic.AMPLITUDE) + 0.5) * 255.0


class Driver(base.Driver):
    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        clock = common.Stopwatch(run.setup_parts)
        from upflow_pytorch_tpu_torch.config import RAFTConfig
        from upflow_pytorch_tpu_torch.models import upflow

        self.upflow = upflow
        self.conf = RAFTConfig().updated(run.config["raft"])
        stated = {k: run.config[k] for k in WIDTHS}
        held = {k: getattr(self.conf, k) for k in WIDTHS}
        stated["encoder_dims"] = list(run.config["encoder_dims"])
        held["encoder_dims"] = list(self.conf.encoder_dims)
        if stated != held:
            raise ValueError("the configuration states %s, the program "
                             "holds %s" % (stated, held))
        clock.lap("program import")
        self.params = reference.init_params(run.seed, run.config)
        fd, path = tempfile.mkstemp(suffix=".pth")
        try:
            with os.fdopen(fd, "wb") as f:
                torch.save(self.params, f)
            self.model = upflow.build_model(self.conf, self.device,
                                            weights=path, seed=run.seed)
        finally:
            os.remove(path)
        clock.lap("model and weights")
        self.pool = {k: to_pixels(v).cpu().numpy()
                     for k, v in synthetic.render(
                         run.seed, range(t["pool_pairs"]), self.hw, self.hw,
                         t["motion"], self.device).items()
                     if k in ("im1", "im2")}
        self.requests = self._requests(int(t["host_batches"]))
        clock.lap("inputs")
        for i in range(int(t["warmup_requests"])):
            self._call(self.requests[i % len(self.requests)])
            common.sync(self.device)
        clock.lap("warm-up")
        common.reset_peak(self.device)

    def flops_per_unit(self) -> float:
        p = {k: torch.empty(v.shape, device="meta")
             for k, v in self.params.items()}
        im = torch.empty((1,) + self.hw + (3,), device="meta")
        return common.count_flops(lambda: reference.forward(
            p, im, im, self.conf.iters))

    def reference_outputs(self, ids: Sequence[int], control=None
                          ) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's outputs (host tensors) for pool pairs ``ids``:
        fp32 with TF32 off, or in a control's precision
        (``lowp.CONTROLS``)."""
        p = {k: v.to(self.device) for k, v in self.params.items()}
        quant, tf32 = lowp.CONTROLS[control]
        block = int(self.run.traffic["reference_pairs"])
        ids = sorted(set(ids))
        out = {}
        with torch.no_grad(), fp32(tf32):
            for s in range(0, len(ids), block):
                part = ids[s:s + block]
                im1 = torch.from_numpy(self.pool["im1"][part]).to(self.device)
                im2 = torch.from_numpy(self.pool["im2"][part]).to(self.device)
                res = reference.forward(p, im1, im2, self.conf.iters,
                                        quant=quant)
                for j, pid in enumerate(part):
                    out[pid] = {k: res[k][j].cpu() for k in KEYS}
        return out
