"""The readings that a cell's limits on ``correct`` are set from, in one
process on the card:

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 4]

For each of ``--seeds`` the program's numbers (the cell's set-up from that
seed, a short window, the same comparison as a run's); for each of
``--control-seeds`` the control's (the reference in the precision below
the configuration's, in the program's place); for each of
``--fault-seeds`` of a training cell the numbers of two faults planted in
the reference put in the program's place: half of each batch left out and
the mean taken over the rest, and the state left unchanged by every step
of the window.  One JSON line each, also appended to
``chiprun_out/readings_<cell>.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.core.runner import Run  # noqa: E402
from benchmark.core.spec import Spec  # noqa: E402


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def half_batch(driver):
    full = driver.reference_steps()
    driver.batches = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                      for b in driver.batches]
    return driver.compare(driver.reference_steps(), full)


def window_unchanged(driver):
    return driver.compare(driver.reference_steps(
        frozen_after=driver.checked), driver.reference_steps())


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--fault-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    spec = Spec(ROOT)
    cell = spec.cell(args.workload)
    config, traffic = spec.config(cell), spec.traffic(cell)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = out / ("readings_%s.jsonl" % args.workload)
    todo = ([(s, ["program"]) for s in args.seeds]
            + [(s, ["control"]) for s in args.control_seeds]
            + [(s, ["window unchanged", "half batch"])
               for s in args.fault_seeds])
    for seed, whats in todo:
        t = time.perf_counter()
        run = Run(seed, False, cell, config, traffic, device)
        driver = spec.driver(traffic).Driver(run, ROOT)
        driver.setup()
        driver.window(args.seconds)
        driver.release()
        for what in whats:
            if what == "program":
                numbers = {c.name: c.value for c in driver.judge(
                    spec.limits(cell))}
            elif what == "control":
                numbers = driver.control()
            elif what == "half batch":
                numbers = half_batch(driver)
            else:
                numbers = window_unchanged(driver)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "what": what, "numbers": numbers,
                               "seconds": time.perf_counter() - t})
            print(line, flush=True)
            with open(log, "a") as f:
                f.write(line + "\n")
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
