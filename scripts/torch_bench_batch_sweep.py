#!/usr/bin/env python3
"""Batch sweep of the PyTorch port's headline forward on one GPU.

    python3 scripts/torch_bench_batch_sweep.py [batches=4,8,16] [iters=20]
        [h=384] [w=1280] [--device cpu]

Port of ``scripts/bench_batch_sweep.py``: times the forward of
``python -m upflow_pytorch_tpu_torch.bench`` (bf16, every kernel, the
checkpoint ``assets/synthetic_trained.npz`` when present) at each batch
with the bench's chained loop (``iters`` dependent forwards a run, the
median of 3 runs after a warm-up run, less the no-op loop), on the pairs
of ``make_dataset(b, seed=7)``, so that the bench's ``BATCH`` is chosen
by measurement on the card.  Prints one JSON line a batch
(``pairs_per_sec``, ``ms_per_batch``; ``compile_s``, the warm-up run's
wall: the packs, the resizes' caches and cuDNN's first choices at the
shape; ``peak_memory_gib``, ``torch.cuda.max_memory_allocated`` from a
reset before the batch, null on the CPU), then a summary (``sweep``,
``best_batch``, ``peak_memory_gib`` by batch, ``weights``,
``loop_dispatch_overhead_s``, the card's name and power limit).  Runs on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Sequence

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from upflow_pytorch_tpu_torch import bench  # noqa: E402
from upflow_pytorch_tpu_torch.utils.misc import (  # noqa: E402
    resolve_device)

DEFAULTS = {"batches": "4,8,16", "iters": "20", "h": "384", "w": "1280"}


def sweep(device, batches: Sequence[int], iters: int, hw) -> Dict[str, Any]:
    """One JSON line a batch, then the summary, which it returns."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    model, used_ckpt = bench.load_model(bench.CONF, device)
    overhead = bench._dispatch_overhead(device, iters)
    # make_dataset(b, seed=7) is the first b pairs of the largest batch's
    data = bench.render_pairs(max(batches), 7, hw)
    results, peaks = {}, {}
    for b in batches:
        im1 = bench.as_nchw(data["im1"][:b], device)
        im2 = bench.as_nchw(data["im2"][:b], device)
        if on_card:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        first, times = bench.timed_runs(
            bench.chained_loop(model, im1, im2, iters))
        dt = bench.net_seconds(times, overhead)
        pps = b * iters / dt
        results[b] = pps
        peaks[b] = (torch.cuda.max_memory_allocated(device) / 2 ** 30
                    if on_card else None)
        print(json.dumps({
            "batch": b, "pairs_per_sec": pps,
            "ms_per_batch": dt / iters * 1e3, "compile_s": first,
            "peak_memory_gib": peaks[b]}), flush=True)
        del im1, im2
    name, power_limit = bench.card(device)
    summary = {"sweep": results, "best_batch": max(results,
                                                   key=results.get),
               "peak_memory_gib": peaks,
               "weights": "ckpt" if used_ckpt else "surrogate",
               "loop_dispatch_overhead_s": overhead, "device": name,
               "power_limit": power_limit, "iters": iters, "hw": list(hw)}
    print(json.dumps(summary), flush=True)
    return summary


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("settings", nargs="*", metavar="KEY=VALUE",
                    help="batches=4,8,16 iters=20 h=384 w=1280")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    settings = dict(DEFAULTS)
    for item in args.settings:
        key, sep, value = item.partition("=")
        if not sep or key not in DEFAULTS:
            ap.error("unknown setting %r (known: %s)"
                     % (item, ", ".join(DEFAULTS)))
        settings[key] = value
    return sweep(args.device,
                 [int(b) for b in settings["batches"].split(",")],
                 int(settings["iters"]),
                 (int(settings["h"]), int(settings["w"])))


if __name__ == "__main__":
    main()
