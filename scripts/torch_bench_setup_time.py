#!/usr/bin/env python3
"""Host seconds to render the bench's synthetic pairs, one after another
(``data/synthetic.py::make_dataset``) and on threads
(``bench.render_pairs``, which the bench and the batch sweep use).

    python3 scripts/torch_bench_setup_time.py [--pairs 16] [--size 384x1280]

The defaults are the batch sweep's setup: the 16 pairs of seed 7 at
384x1280.  Prints one JSON line: ``pairs``, ``hw``, ``threads``,
``serial_s``, ``threaded_s`` and ``equal`` (the two renders' arrays equal).
Needs no card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from upflow_pytorch_tpu_torch import bench  # noqa: E402
from upflow_pytorch_tpu_torch.data.synthetic import (  # noqa: E402
    make_dataset)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=16)
    ap.add_argument("--size", type=bench.parse_hw,
                    default=(bench.HEIGHT, bench.WIDTH), metavar="HxW")
    args = ap.parse_args(argv)
    hw = args.size
    t0 = time.perf_counter()
    serial = make_dataset(args.pairs, seed=7, raw_hw=hw, crop_hw=hw)
    t1 = time.perf_counter()
    threaded = bench.render_pairs(args.pairs, 7, hw)
    t2 = time.perf_counter()
    result = {"pairs": args.pairs, "hw": list(hw),
              "threads": min(args.pairs, os.cpu_count() or 1),
              "serial_s": t1 - t0, "threaded_s": t2 - t1,
              "equal": all(np.array_equal(serial[k], threaded[k])
                           for k in serial)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
