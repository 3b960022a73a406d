"""Serving in a closed loop: one client calls the port's entry
``models/upflow.py::forward(model, im1, im2)`` with NHWC fp32 numpy
batches and waits for each (``torch.cuda.synchronize()``) before the
next, so a request's latency covers the host-to-device copy, the network,
the occlusion check and the outputs' layout.

Traffic parameters (``benchmark/traffic/<mix>.json``): ``batch``,
``height_width``, ``pool_pairs`` distinct pairs rendered from the seed,
``host_batches`` request batches made from them (each a fresh permutation
of the pool, cut into batches, as separate host arrays) and cycled,
``motion`` (the pairs' largest shift, rotation and zoom),
``warmup_requests``, ``checked_requests`` (requests whose outputs are kept
for the check, at times drawn from the seed), ``profile_requests`` (the
traced slice) and ``reference_pairs`` (the reference's pairs a call).

``correct``: each kept request's flows and occlusion masks against the
plain reference's on the same pairs; the numbers are the worst pair's
mean end-point error (px, both directions) and share of occlusion pixels
that differ.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from benchmark.core import trace
from benchmark.core.runner import Check, Window
from benchmark.drivers import common
from benchmark.reference import lowp, npz, synthetic
from benchmark.reference import upflow as reference

KEYS = ("flow_f_out", "flow_b_out", "occ_fw", "occ_bw")


@dataclasses.dataclass
class Request:
    ids: List[int]  # pool pairs, in batch order
    im1: np.ndarray
    im2: np.ndarray


class Driver:
    def __init__(self, run, root):
        self.run, self.root = run, root
        t = run.traffic
        self.batch = int(t["batch"])
        self.hw = tuple(t["height_width"])
        self.device = run.device
        self.weights = str(root / run.config["weights"])

    def setup(self) -> None:
        run, t = self.run, self.run.traffic
        clock = common.Stopwatch(run.setup_parts)
        conf = common.program_config(run.config)
        from upflow_pytorch_tpu_torch.models import upflow

        self.upflow = upflow
        clock.lap("program import")
        self.model = upflow.build_model(conf, self.device,
                                        weights=self.weights)
        clock.lap("model and weights")
        self.pool = {k: v.cpu().numpy() for k, v in synthetic.render(
            run.seed, range(t["pool_pairs"]), self.hw, self.hw, t["motion"],
            self.device).items() if k in ("im1", "im2")}
        self.requests = self._requests(int(t["host_batches"]))
        clock.lap("inputs")
        for i in range(int(t["warmup_requests"])):
            self._call(self.requests[i % len(self.requests)])
            common.sync(self.device)
        clock.lap("warm-up")
        common.reset_peak(self.device)

    def _requests(self, n: int) -> List[Request]:
        pool = self.pool["im1"].shape[0]
        rng = np.random.default_rng([self.run.seed, 1])
        order: List[int] = []
        while len(order) < n * self.batch:
            order += [int(i) for i in rng.permutation(pool)]
        out = []
        for k in range(n):
            ids = order[k * self.batch:(k + 1) * self.batch]
            out.append(Request(
                ids, np.ascontiguousarray(self.pool["im1"][ids]),
                np.ascontiguousarray(self.pool["im2"][ids])))
        return out

    def _call(self, req: Request) -> Dict[str, Any]:
        return self.upflow.forward(self.model, req.im1, req.im2)

    def window(self, seconds: float) -> Window:
        rng = np.random.default_rng([self.run.seed, 2])
        due = sorted(rng.uniform(0, 0.9 * seconds,
                                 int(self.run.traffic["checked_requests"])))
        self.kept = []
        latency, enqueue, ends = [], [], []
        i, start = 0, time.perf_counter()
        end = start
        while True:
            t0 = time.perf_counter()
            if t0 - start >= seconds:
                break
            req = self.requests[i % len(self.requests)]
            out = self._call(req)
            t1 = time.perf_counter()
            common.sync(self.device)
            end = time.perf_counter()
            latency.append(end - t0)
            enqueue.append(t1 - t0)
            ends.append(end - start)
            # the request in flight at a drawn time is kept
            if due and end - start >= due[0]:
                while due and end - start >= due[0]:
                    due.pop(0)
                self.kept.append((req.ids, {k: out[k].cpu() for k in KEYS}))
            i += 1
        return Window(end - start, i, i * self.batch, latency, enqueue,
                      ends)

    def peak_bytes(self) -> int:
        return common.peak_bytes(self.device)

    def profile(self, ops) -> trace.Trace:
        n = int(self.run.traffic["profile_requests"])

        def requests() -> int:
            for i in range(n):
                self._call(self.requests[i % len(self.requests)])
                common.sync(self.device)
            return n

        return trace.capture(requests, self.device, ops,
                             self.run.config["program"], self.batch)

    def flops_per_unit(self) -> float:
        p = common.meta_params(self.weights)
        im = torch.empty((1,) + self.hw + (3,), device="meta")
        return common.count_flops(
            lambda: reference.forward(p, im, im, common.numerics(
                self.run.config)))

    def release(self) -> None:
        self.model = None
        common.free(self.device)

    # --- the check ----------------------------------------------------------

    def reference_outputs(self, ids: Sequence[int], control=None
                          ) -> Dict[int, Dict[str, torch.Tensor]]:
        """The reference's outputs (host tensors) for pool pairs ``ids``:
        fp32 with TF32 off, or in a control's precision
        (``lowp.CONTROLS``)."""
        p = npz.load_params(self.weights, self.device)
        quant, tf32 = lowp.CONTROLS[control]
        num = common.numerics(self.run.config, quant)
        block = int(self.run.traffic["reference_pairs"])
        ids = sorted(set(ids))
        out = {}
        with torch.no_grad(), reference.fp32(tf32):
            for s in range(0, len(ids), block):
                part = ids[s:s + block]
                im1 = torch.from_numpy(self.pool["im1"][part]).to(self.device)
                im2 = torch.from_numpy(self.pool["im2"][part]).to(self.device)
                res = reference.forward(p, im1, im2, num)
                for j, pid in enumerate(part):
                    out[pid] = {k: res[k][j].cpu() for k in KEYS}
        return out

    @staticmethod
    def compare(samples, ref) -> Dict[str, float]:
        """The worst pair's mean end-point error and occlusion share that
        differ, over ``samples`` [(ids, outputs)] against ``ref``."""
        epe, occ = 0.0, 0.0
        for ids, out in samples:
            for j, pid in enumerate(ids):
                r = ref[pid]
                e = sum(float((out[k][j] - r[k]).norm(dim=-1).mean())
                        for k in KEYS[:2]) / 2
                o = sum(float((out[k][j] != r[k]).float().mean())
                        for k in KEYS[2:]) / 2
                epe, occ = max(epe, e), max(occ, o)
        return {"flow_epe_px": epe, "occ_differ_share": occ}

    def judge(self, limits: Dict[str, float]) -> List[Check]:
        ids = [pid for ids, _ in self.kept for pid in ids]
        if not ids:
            return [Check("checked_requests", 0.0, -1.0)]
        numbers = self.compare(self.kept, self.reference_outputs(ids))
        return [Check(k, v, float(limits[k])) for k, v in numbers.items()]

    def control(self) -> Dict[str, float]:
        """The control's numbers: the reference in the precision below the
        configuration's (its ``control``) in the program's place, on the
        kept requests' pairs."""
        ids = [pid for ids, _ in self.kept for pid in ids]
        ctl = self.reference_outputs(ids, self.run.config["control"])
        samples = [(list(ctl), {k: torch.stack([ctl[i][k] for i in ctl])
                                for k in KEYS})]
        return self.compare(samples, self.reference_outputs(ids))
