"""Runs one cell once and prints its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell's driver sets the program up from the seed (``setup_s`` runs from
the process's start to the first timed call), runs the measured window,
and with ``--trace 1`` two short profiled slices after it; the cell's metric
readers read the run; then the driver frees the program, runs the plain
reference on what the window produced and returns the numbers that decide
``correct``, each beside its limit.  The last line of standard output is
the result, the last lines of standard error the numbers and limits.

Exit codes: 0 with a result; 2 without CUDA or with fewer cards than the
cell asks for; 3 when JAX or the JAX package is loaded once the window has
closed.  Anything else that fails raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

from benchmark.core.spec import ROOT, Spec

FORBIDDEN = {"jax", "jaxlib", "flax", "upflow_pytorch_tpu"}


@dataclasses.dataclass
class Window:
    seconds: float  # from the first call to the last call's completion
    calls: int  # requests or steps
    units: int  # frame pairs served or trained
    latency_s: List[float]  # per call, to its synchronise
    enqueue_s: List[float]  # per call, to its return
    ends: List[float]  # per call, its completion from the window's start
    failed: int = 0

    def rates(self, parts: int = 4) -> List[float]:
        """Pairs a second in each of ``parts`` equal slices of the window,
        by completion time: how steady the window ran."""
        per = self.units / max(self.calls, 1)
        edges = [self.seconds * i / parts for i in range(parts + 1)]
        return [per * sum(a <= t < b for t in self.ends) / (b - a)
                for a, b in zip(edges, edges[1:])]


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    """What one run measured, for the metric readers."""

    seed: int
    trace_on: bool
    cell: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    device: Any
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)
    setup_s: float = 0.0
    window: Optional[Window] = None
    peak_bytes: int = 0
    trace: Any = None
    flops_per_unit: Optional[float] = None  # the reference's, per pair


def parse(argv: List[str]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as err:
        return "nvidia-smi failed: %s" % err


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv: List[str], t0: float, root: Path = ROOT,
         device=None) -> int:
    """``device``: None looks for the cards the cell asks for (the
    benchmark's runs); a test passes ``torch.device('cpu')`` to run the
    rest of a run without one."""
    args = parse(argv)
    spec = Spec(root)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell), spec.traffic(cell)
    import torch

    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell["chips"]):
            print("no result: the cell needs %d CUDA device(s), found %d"
                  % (cell["chips"], torch.cuda.device_count()
                     if torch.cuda.is_available() else 0), file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    run = Run(args.seed, bool(args.trace), cell, config, traffic, device)
    run.setup_parts["imports"] = time.perf_counter() - t0
    driver = spec.driver(traffic).Driver(run, root)
    driver.setup()
    # what set-up made stays out of the collector's later passes
    gc.collect()
    gc.freeze()
    run.setup_s = time.perf_counter() - t0
    run.window = driver.window(args.seconds)
    gc.unfreeze()
    run.peak_bytes = driver.peak_bytes()
    if run.trace_on:
        run.trace = driver.profile(spec.ops())
        run.flops_per_unit = driver.flops_per_unit()
    metrics = {}
    for m in spec.metrics(cell, run.trace_on):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    driver.release()
    checks = driver.judge(spec.limits(cell))

    found = loaded_forbidden()
    if found:
        print("no result: loaded once the window closed: %s"
              % ", ".join(found), file=sys.stderr)
        return 3
    on_card = device.type == "cuda"
    print("card: %s" % (card_line() if on_card else "none (cpu)"))
    print("set-up parts, s: %s" % json.dumps(run.setup_parts))
    w = run.window
    lat = sorted(w.latency_s)
    print("window: %d calls, %d pairs, %.6f s; latency ms: median %.3f, "
          "p95 %.3f, max %.3f; enqueue ms: mean %.3f; pairs/s by quarter: "
          "%s" % (w.calls, w.units, w.seconds, 1e3 * lat[len(lat) // 2],
                  1e3 * lat[int(0.95 * (len(lat) - 1))], 1e3 * lat[-1],
                  1e3 * sum(w.enqueue_s) / len(w.enqueue_s),
                  " ".join("%.3f" % r for r in w.rates())))
    result: Dict[str, Any] = {
        "correct": all(c.ok for c in checks),
        "attempted": w.calls, "failed": w.failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if on_card else "cpu"),
                   "count": cell["chips"],
                   "memory_peak_bytes": run.peak_bytes}}
    if run.trace is not None:
        t = run.trace
        print("profiled slice: %d calls, %.6f s, device busy %.6f s, idle "
              "%.3f%%" % (t.calls, t.wall_s, t.busy_s,
                          100 * (1 - t.busy_s / t.wall_s)))
        result["device"]["busy_s"] = t.busy_s
        result["device"]["window_s"] = t.wall_s
        result["breakdown"] = {"device_ops": t.top_ops(),
                               "idle_gaps": t.top_gaps()}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    for c in checks:
        print("check %s %r limit %r %s" % (c.name, c.value, c.limit,
                                           "ok" if c.ok else "FAILED"),
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
