"""GMFlow served in a closed loop: ``serve_raft_closed_loop``'s client,
window, profiled slices, pairs and check, with GMFlow's set-up, FLOP count
and reference.

The configuration file's ``gmflow`` holds the ``GMFlowConfig`` field it
sets (``compute_dtype``) and its top-level widths are GMFlow's published
ones, which the set-up holds the program's to.  The weights are drawn
here from the run's seed and the widths (GMFlow's initialisation with
smaller features, ``reference/gmflow.py::init_params``), saved as a state dict under the
run's temporary directory and loaded by the program's
``build_model(conf, weights=...)``: the reference never takes the
program's initialisation.  A program without ``GMFlowConfig`` fails in
set-up with an ``ImportError``.

``correct``: against ``reference/gmflow.py`` run in blocks of
``reference_pairs``, both directions of each pair, the median over the
kept pairs of each pair's mean end-point error of both flows
(``median_pair_epe_px``) and of its share of occlusion pixels that differ
(``median_pair_occ_share``).  The median and not the worst pair, as
``serve_closed_loop`` takes: the drawn weights keep GMFlow's softmaxes off
an argmax among near-ties (``reference/gmflow.py::init_params``), so the
flows move smoothly with the features, but how far a pair's flows move
for one rounding differs tenfold from pair to pair (one pair of eight
reads 6.7 px where the others read 0.2-1.9 on the H100), while a fault
or a lower precision moves every pair.  The limits sit between a sound
run and the fp8 control and the faults that
``benchmark/tools/gmflow_faults.py`` plants (PERF.md, section 4).
"""

from __future__ import annotations

import os
import statistics
import tempfile
from typing import Dict, Sequence

import torch

from benchmark.drivers import common
from benchmark.drivers import serve_raft_closed_loop as base
from benchmark.reference import gmflow as reference
from benchmark.reference import lowp, synthetic
from benchmark.reference.upflow import fp32

KEYS = base.KEYS
WIDTHS = ("feature_channels", "num_transformer_layers", "num_head",
          "ffn_dim_expansion", "upsample_factor", "attn_splits",
          "padding_factor")


class Driver(base.Driver):
    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        clock = common.Stopwatch(run.setup_parts)
        from upflow_pytorch_tpu_torch.config import GMFlowConfig
        from upflow_pytorch_tpu_torch.models import upflow

        self.upflow = upflow
        self.conf = GMFlowConfig().updated(run.config["gmflow"])
        stated = {k: run.config[k] for k in WIDTHS}
        held = {k: getattr(self.conf, k) for k in WIDTHS}
        stated["backbone_dims"] = list(run.config["backbone_dims"])
        held["backbone_dims"] = list(self.conf.backbone_dims)
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
        self.pool = {k: base.to_pixels(v).cpu().numpy()
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
            p, im, im, self.run.config))

    @staticmethod
    def compare(samples, ref) -> Dict[str, float]:
        """The median over ``samples`` [(ids, outputs)] of each pair's
        mean end-point error of both flows and of its share of occlusion
        pixels that differ, against ``ref``."""
        epe, occ = [], []
        for ids, out in samples:
            for j, pid in enumerate(ids):
                r = ref[pid]
                epe.append(sum(float((out[k][j] - r[k]).norm(dim=-1).mean())
                               for k in KEYS[:2]) / 2)
                occ.append(sum(float((out[k][j] != r[k]).float().mean())
                               for k in KEYS[2:]) / 2)
        return {"median_pair_epe_px": statistics.median(epe),
                "median_pair_occ_share": statistics.median(occ)}

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
                res = reference.forward(p, im1, im2, self.run.config,
                                        quant=quant)
                for j, pid in enumerate(part):
                    out[pid] = {k: res[k][j].cpu() for k in KEYS}
        return out
