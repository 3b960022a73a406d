"""Faults planted in the program of the GMFlow cell
(``serve_gmflow_bf16_kitti_b1``), each read by the cell's own check, in one
process on the card:

    python3 benchmark/tools/gmflow_faults.py --seeds 1,2,3
        [--faults no_shift_mask,skip_block_0,...] [--seconds 4]

Each fault is patched into the program's Python before the cell's set-up,
so that the eager calls and the captured graph both run it; the set-up,
a short window and the comparison are a run's.  The faults, each a
mistake of the size a port could make and its tests could miss:

- ``no_shift_mask``: the shifted blocks attend without Swin's mask;
- ``skip_block_<i>``: the Transformer's block ``i`` returns its input;
- ``propagate_scale_sqrt2``: the propagation's softmax at sqrt(2) times
  its scale;
- ``drop_last_key_tile``: every ``global_match`` call (matching and
  propagation) leaves out the last 64 keys, the kernel's last key tile.

One JSON line a fault and seed (the numbers, each with its limit and
whether it passed), also appended to
``chiprun_out/faults_serve_gmflow_bf16_kitti_b1.jsonl``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.core.runner import Run  # noqa: E402
from benchmark.core.spec import Spec  # noqa: E402

CELL = "serve_gmflow_bf16_kitti_b1"
FAULTS = ("no_shift_mask", "skip_block_0", "skip_block_5",
          "propagate_scale_sqrt2", "drop_last_key_tile")
KEY_TILE = 64  # csrc/global_match.cu's keys a tile
BLOCKS = 6  # the Transformer's


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault``; as it was after the block."""
    from upflow_pytorch_tpu_torch.models import gmflow

    saved = {n: getattr(gmflow, n) for n in ("attend", "global_match")}
    forward = gmflow.TransformerBlock.forward
    attend, match = saved["attend"], saved["global_match"]
    calls = [0]
    if fault == "no_shift_mask":
        gmflow.attend = lambda q, k, v, mask=None: attend(q, k, v)
    elif fault.startswith("skip_block_"):
        i = int(fault[len("skip_block_"):])

        def skipped(self, source, *args):
            calls[0] += 1  # a request calls the blocks in their order
            if (calls[0] - 1) % BLOCKS == i:
                return source
            return forward(self, source, *args)
        gmflow.TransformerBlock.forward = skipped
    elif fault == "propagate_scale_sqrt2":
        def scaled(q, k, v, scale):
            calls[0] += 1  # a request calls the matching, then propagation
            return match(q, k, v, scale * (math.sqrt(2.0)
                                           if calls[0] % 2 == 0 else 1.0))
        gmflow.global_match = scaled
    elif fault == "drop_last_key_tile":
        gmflow.global_match = lambda q, k, v, scale: match(
            q, k[:, :-KEY_TILE].contiguous(), v[:, :-KEY_TILE].contiguous(),
            scale)
    else:
        raise ValueError("no fault %r" % fault)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(gmflow, n, f)
        gmflow.TransformerBlock.forward = forward


def names(text: str):
    return [s for s in text.split(",") if s]


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=lambda t: [int(s) for s in names(t)],
                    required=True)
    ap.add_argument("--faults", type=names, default=list(FAULTS))
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    spec = Spec(ROOT)
    cell = spec.cell(CELL)
    config, traffic = spec.config(cell), spec.traffic(cell)
    limits = spec.limits(cell)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    log = out / ("faults_%s.jsonl" % CELL)
    for fault in args.faults:
        for seed in args.seeds:
            t = time.perf_counter()
            with planted(fault):
                run = Run(seed, False, cell, config, traffic, device)
                driver = spec.driver(traffic).Driver(run, ROOT)
                driver.setup()
                driver.window(args.seconds)
                driver.release()
                checks = driver.judge(limits)
            line = json.dumps({
                "workload": CELL, "seed": seed, "what": fault,
                "numbers": {c.name: c.value for c in checks},
                "limits": {c.name: c.limit for c in checks},
                "correct": all(c.ok for c in checks),
                "seconds": time.perf_counter() - t})
            print(line, flush=True)
            with open(log, "a") as f:
                f.write(line + "\n")
            del driver
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
